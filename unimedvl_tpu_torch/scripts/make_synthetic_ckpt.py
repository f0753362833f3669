"""Write a synthetic released-format checkpoint from a seed (the port's
counterpart of scripts/make_synthetic_ckpt.py).

It rehearses the real-checkpoint path (sharded safetensors with their index,
the loader's conversions, quantization at load, placement) without the
released weights, which are not in the repository. The weights are the
port's random initialization (``models.bagel.init_random_``, the JAX
package's distributions) from ``--seed``: their values mean nothing, their
names, shapes, dtypes and layout are the released ones.

The geometry is the released 14B one (Qwen2.5-7B MoT: vocab 152064, hidden
3584, 18944, 28 layers, 28 / 4 heads; SigLIP-SO400M/14 at 980 px, 27 layers
shipped; the FLUX VAE), or any other: ``--config-dir`` takes
llm_config.json / vit_config.json from a directory, ``--layers`` cuts the
LLM's depth, ``--no-vae`` leaves out ae.safetensors. Written:

  OUT/llm_config.json, OUT/vit_config.json
  OUT/ema.safetensors, or shards with model.safetensors.index.json (--shard-gb)
  OUT/ae.safetensors (fp32)
  OUT/tokenizer.json, tokenizer_config.json: a minimal byte-level BPE that
      AutoTokenizer loads (not the Qwen2 vocabulary)

    python -m unimedvl_tpu_torch.scripts.make_synthetic_ckpt OUT [--shard-gb 4] [--seed 0]
        [--config-dir DIR] [--layers N] [--no-vae] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# the released geometry (SURVEY.md section 2.2)
LLM_JSON = {
    "vocab_size": 152064, "hidden_size": 3584, "intermediate_size": 18944,
    "num_hidden_layers": 28, "num_attention_heads": 28, "num_key_value_heads": 4,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
}
VIT_JSON = {
    "hidden_size": 1152, "intermediate_size": 4304,
    "num_hidden_layers": 27,  # the reader drops the last one: 26 used
    "num_attention_heads": 16, "image_size": 980, "patch_size": 14, "layer_norm_eps": 1e-06,
}


def write_tokenizer(out_dir: str) -> None:
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    vocab = {chr(i + 33): i for i in range(80)}
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[], unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.save(os.path.join(out_dir, "tokenizer.json"))
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--shard-gb", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config-dir", default=None,
                    help="take llm_config.json / vit_config.json from here (default: the "
                         "released geometry)")
    ap.add_argument("--layers", type=int, default=None, help="LLM depth (default: the config's)")
    ap.add_argument("--no-vae", action="store_true", help="write no ae.safetensors")
    ap.add_argument("--device", default="cuda", help="where the weights are drawn (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from unimedvl_tpu_torch.config import BagelConfig
    from unimedvl_tpu_torch.models import bagel
    from unimedvl_tpu_torch.weights.bagel_export import export_bagel_checkpoint
    from unimedvl_tpu_torch.weights.loader import _target_device

    device = _target_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    src = args.config_dir
    if src is None:  # the released geometry, through the reader's own rules
        src = args.out_dir
        for name, d in (("llm_config.json", LLM_JSON), ("vit_config.json", VIT_JSON)):
            with open(os.path.join(src, name), "w") as f:
                json.dump(d, f, indent=1)
    cfg = BagelConfig.from_checkpoint_dir(src)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                               num_hidden_layers=args.layers))
    model = bagel.Bagel(cfg, device="meta", dtype=torch.bfloat16, with_vae=not args.no_vae)
    model = model.to_empty(device=device)
    bagel.init_random_(model, torch.Generator(device=device).manual_seed(args.seed),
                       llm2vae_zero=False)
    written = export_bagel_checkpoint(args.out_dir, model, shard_gb=args.shard_gb)
    write_tokenizer(args.out_dir)
    n = sum(p.numel() for name, p in model.named_parameters() if not name.startswith("vae_"))
    print(f"wrote {n / 1e9:.3f} B parameters in {sum(v == 'weights' for v in written.values())} "
          f"weight files -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
