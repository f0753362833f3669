"""Tokenizer loading + special-token registration (the port's own copy of
``unimedvl_tpu/data/tokenizer.py``).

Mirrors data_utils.py:140-175: ensures <|im_start|> (bos), <|im_end|> (eos),
<|vision_start|>, <|vision_end|> exist and returns their ids. Any HF tokenizer
with ``encode/decode/add_tokens/convert_tokens_to_ids`` works (the released
checkpoints ship a Qwen2 byte-level BPE).
"""

from __future__ import annotations

from typing import Dict, Tuple


SPECIAL_TOKENS = ("<|im_start|>", "<|im_end|>", "<|vision_start|>", "<|vision_end|>")


def add_special_tokens(tokenizer) -> Tuple[object, Dict[str, int], int]:
    all_special = []
    for v in getattr(tokenizer, "special_tokens_map", {}).values():
        if isinstance(v, str):
            all_special.append(v)
        elif isinstance(v, list):
            all_special += v

    new_tokens = [t for t in SPECIAL_TOKENS if t not in all_special]
    num_new = tokenizer.add_tokens(new_tokens) if new_tokens else 0

    new_token_ids = dict(
        bos_token_id=tokenizer.convert_tokens_to_ids("<|im_start|>"),
        eos_token_id=tokenizer.convert_tokens_to_ids("<|im_end|>"),
        start_of_image=tokenizer.convert_tokens_to_ids("<|vision_start|>"),
        end_of_image=tokenizer.convert_tokens_to_ids("<|vision_end|>"),
    )
    return tokenizer, new_token_ids, num_new


class ByteTokenizer:
    """A byte-level stand-in for runs with random weights (the smoke run, the
    dry-run tools): ids 0-255 are the text's UTF-8 bytes, special tokens get
    ids from 256 up. Other ids decode as ``<id>``."""

    def __init__(self):
        self.specials = {}
        self.special_tokens_map = {}

    def add_tokens(self, tokens):
        for t in tokens:
            self.specials.setdefault(t, 256 + len(self.specials))
        return len(tokens)

    def convert_tokens_to_ids(self, tok):
        return self.specials[tok]

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        inv = {v: k for k, v in self.specials.items()}
        return "".join(inv.get(i, chr(i) if i < 128 else f"<{i}>") for i in ids)


def load_tokenizer(path: str):
    """Load the checkpoint tokenizer and register special tokens."""
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(path)
    return add_special_tokens(tokenizer)
