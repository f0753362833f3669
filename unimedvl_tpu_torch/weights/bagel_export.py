"""Checkpoint exporter (port of unimedvl_tpu/weights/bagel_export.py): a
:class:`~unimedvl_tpu_torch.models.bagel.Bagel` written as a released-format
UniMedVL checkpoint, the inverse of ``weights.loader.load_bagel_checkpoint``
(reference layout: interactive_vqa_inferencer.py:127-213):

    llm_config.json, vit_config.json
    ema.safetensors, or ema-0000i-of-0000n.safetensors shards above
        ``shard_gb`` with model.safetensors.index.json
    ae.safetensors (the FLUX VAE, fp32)

    model = load_bagel_checkpoint(src_dir)
    ... fine-tune (full or LoRA) ...
    export_bagel_checkpoint(dst_dir, model)     # merges LoRA itself
    reloaded = load_bagel_checkpoint(dst_dir)   # the same weights

The port's parameter names are the released ones and its linear weights are
[out, in] as released, so most tensors are written as they are. The
conversions the loader undoes:

* The ViT patch embedding, held as a linear [C, p*p*3], is written as the
  released conv [C, 3, p, p] (inverse of siglip_navit.py:176-179).
* The released ViT ships one layer more than it uses
  (interactive_vqa_inferencer.py:213): a zero layer is appended and
  ``vit_config.json`` says ``num_hidden_layers + 1``, so a reload drops it
  again.
* LoRA adapters are merged on the fly, in fp32 (the model is not changed); a
  quantized model is refused: export the bf16 weights it was quantized from.
* The REPA projections of ``cfg.e2e`` are training state, not released
  weights: they are not written.

Tensors go to the host one at a time, so an export of the 14B model needs
host memory for one shard, not for the model.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Iterator, Optional, Tuple

import torch

from unimedvl_tpu_torch.config import BagelConfig, LLMConfig, ViTConfig
from unimedvl_tpu_torch.models.layers import LoRALinear

Entry = Tuple[str, torch.Tensor]
_ADAPTER_SUFFIXES = (".lora_a", ".lora_b", ".lora_s")


class _View:
    """A module's tensors by released name as the export writes them:
    ``overrides`` (e.g. an EMA shadow, by parameter name) in place of the
    module's own, every adapter folded into its base weight in fp32."""

    def __init__(self, module: torch.nn.Module, overrides: Optional[Dict] = None):
        self.sd = module.state_dict()
        quantized = [k for k in self.sd if k.endswith(".weight_q")]
        if quantized:
            raise ValueError(
                f"the model holds quantized weights ({quantized[0]}, ...): export the bf16 "
                "weights it was quantized from (quantize again after reload)")
        for name, t in (overrides or {}).items():
            if name in self.sd:
                self.sd[name] = t
        self.adapted = {path for path, m in module.named_modules() if isinstance(m, LoRALinear)}

    def names(self, prefix: str):
        return [k for k in self.sd if k.startswith(prefix) and not k.endswith(_ADAPTER_SUFFIXES)]

    def get(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        t = self.sd[name]
        path = name[: -len(".weight")]
        if name.endswith(".weight") and path in self.adapted:
            a, b = self.sd[path + ".lora_a"], self.sd[path + ".lora_b"]
            t = t.float() + (b.float() @ a.float()) * self.sd[path + ".lora_s"].float()
        return t.detach().to(device="cpu", dtype=dtype).contiguous()


def iter_llm_state_dict(view: _View, dtype, prefix: str = "language_model.") -> Iterator[Entry]:
    """The LLM's entries (names: qwen2_navit.py:389-407, 713-731, 1025-1043,
    1179-1187), adapters merged."""
    for name in view.names(prefix):
        yield name, view.get(name, dtype)


def iter_vit_state_dict(view: _View, cfg: ViTConfig, dtype,
                        prefix: str = "vit_model.vision_model.") -> Iterator[Entry]:
    """The ViT's entries with the patch embedding as the released conv and
    one zero layer appended at index ``cfg.num_hidden_layers``."""
    p, c = cfg.patch_size, cfg.num_channels
    for name in view.names(prefix):
        t = view.get(name, dtype)
        if name.endswith("embeddings.patch_embedding.weight"):
            # [D, p*p*c] in (p, q, channel) order -> [D, c, p, p]
            t = t.reshape(t.shape[0], p, p, c).permute(0, 3, 1, 2).contiguous()
        yield name, t
    last = f"{prefix}encoder.layers.{cfg.num_hidden_layers - 1}."
    extra = f"{prefix}encoder.layers.{cfg.num_hidden_layers}."
    for sub in view.names(last):  # the unused trailing layer the releases ship
        yield extra + sub[len(last):], torch.zeros_like(view.get(sub, dtype))


def iter_bagel_state_dict(model, dtype=torch.bfloat16, overrides: Optional[Dict] = None,
                          view: Optional[_View] = None) -> Iterator[Entry]:
    """Every ema.safetensors entry of ``model`` (the VAE goes to
    ae.safetensors; the REPA projections nowhere), ``overrides`` by
    parameter name in place of the model's tensors."""
    cfg = model.config
    view = view or _View(model, overrides)
    yield from iter_llm_state_dict(view, dtype)
    if cfg.visual_und and cfg.vit is not None and hasattr(model, "vit_model"):
        yield from iter_vit_state_dict(view, cfg.vit, dtype)
        for name in view.names("connector.") + view.names("vit_pos_embed."):
            yield name, view.get(name, dtype)
    if cfg.visual_gen and hasattr(model, "vae2llm"):
        for part in ("vae2llm.", "llm2vae.", "time_embedder.", "latent_pos_embed."):
            for name in view.names(part):
                yield name, view.get(name, dtype)


def vae_state_dict(vae, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The AutoEncoder's state under the released ae.safetensors names (the
    port keeps them: OIHW convolutions), on the host in ``dtype``."""
    return {k: v.detach().to(device="cpu", dtype=dtype).contiguous()
            for k, v in vae.state_dict().items()}


def _llm_config_json(cfg: LLMConfig) -> Dict:
    d = dataclasses.asdict(cfg)
    for key in ("head_dim_override", "remat", "freeze_und"):
        d.pop(key, None)
    return d


def _vit_config_json(cfg: ViTConfig) -> Dict:
    d = dataclasses.asdict(cfg)
    d["num_hidden_layers"] = cfg.num_hidden_layers + 1  # from_json_file takes it off again
    return d


def export_bagel_checkpoint(
    out_dir: str,
    model,
    dtype: torch.dtype = torch.bfloat16,
    shard_gb: float = 4.0,
    name: str = "ema",
    tokenizer_src: Optional[str] = None,
    overrides: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, str]:
    """Write ``model`` (a Bagel) as a released-format checkpoint directory;
    returns ``{file name: kind}``. Weights in ``dtype`` (bf16, the released
    checkpoints' dtype), the VAE in fp32. ``overrides``: tensors by parameter
    name written in place of the model's (``TrainState.ema_params``: export
    the EMA shadow). LoRA adapters are merged; a quantized model raises
    ``ValueError``. ``tokenizer_src``: a directory whose tokenizer files are
    copied beside the weights."""
    from safetensors.torch import save_file

    cfg: BagelConfig = model.config
    view = _View(model, overrides)
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}
    with open(os.path.join(out_dir, "llm_config.json"), "w") as f:
        json.dump(_llm_config_json(cfg.llm), f, indent=1)
    written["llm_config.json"] = "config"
    if cfg.visual_und and cfg.vit is not None and hasattr(model, "vit_model"):
        with open(os.path.join(out_dir, "vit_config.json"), "w") as f:
            json.dump(_vit_config_json(cfg.vit), f, indent=1)
        written["vit_config.json"] = "config"

    limit = int(shard_gb * (1 << 30))
    shards, shard, shard_bytes = [], {}, 0
    for key, t in iter_bagel_state_dict(model, dtype, view=view):
        n = t.numel() * t.element_size()
        if shard_bytes + n > limit and shard:
            shards.append(shard)
            shard, shard_bytes = {}, 0
        shard[key] = t
        shard_bytes += n
    if shard:
        shards.append(shard)
    if len(shards) == 1:
        fname = f"{name}.safetensors"
        save_file(shards[0], os.path.join(out_dir, fname))
        written[fname] = "weights"
    else:
        weight_map = {}
        for i, s in enumerate(shards):
            fname = f"{name}-{i:05d}-of-{len(shards):05d}.safetensors"
            save_file(s, os.path.join(out_dir, fname))
            written[fname] = "weights"
            weight_map.update({k: fname for k in s})
        idx = "model.safetensors.index.json"  # the loaders look for this name
        with open(os.path.join(out_dir, idx), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
        written[idx] = "index"

    if cfg.visual_gen and hasattr(model, "vae_model"):
        save_file(vae_state_dict(model.vae_model), os.path.join(out_dir, "ae.safetensors"))
        written["ae.safetensors"] = "weights"
    if tokenizer_src is not None:
        for fname in ("tokenizer.json", "tokenizer_config.json", "vocab.json", "merges.txt",
                      "special_tokens_map.json"):
            src = os.path.join(tokenizer_src, fname)
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out_dir, fname))
                written[fname] = "tokenizer"
    return written
