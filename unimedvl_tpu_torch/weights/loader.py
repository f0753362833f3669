"""Weights into a :class:`~unimedvl_tpu_torch.models.bagel.Bagel` (port of
unimedvl_tpu/weights/bagel_loader.py).

The port's parameter names are the released checkpoint's, and torch Linear
weights are [out, in] as released, so ``load_bagel_checkpoint`` reads each
tensor by name with no transpose. Two conversions remain, as in the JAX
loader: the ViT conv patch embedding [C, 3, p, p] becomes its linear form
[C, p*p*3] (siglip_navit.py:176-179), and the checkpoint's last ViT layer is
dropped (``ViTConfig.from_json_file`` already counts one layer fewer).

``from_jax_params`` builds the same model from the JAX package's parameter
tree (numpy leaves), so both packages compute one function in the tests.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from unimedvl_tpu.config import BagelConfig
from unimedvl_tpu_torch.models.bagel import Bagel


def _build(state: Dict[str, torch.Tensor], cfg: BagelConfig, device, dtype) -> Bagel:
    model = Bagel(cfg, device="meta", dtype=dtype)
    state = {k: v.to(device=device, dtype=dtype) for k, v in state.items()}
    model.load_state_dict(state, strict=True, assign=True)  # keeps requires_grad=False
    return model


# ---------------------------------------------------------------------------
# JAX parameter tree -> released names
# ---------------------------------------------------------------------------

def _lin(sd, name, p, i=None):
    pick = (lambda a: a[i]) if i is not None else (lambda a: a)
    sd[name + ".weight"] = np.ascontiguousarray(pick(np.asarray(p["kernel"])).T)
    if "bias" in p:
        sd[name + ".bias"] = pick(np.asarray(p["bias"]))


def jax_tree_to_state_dict(tree: Dict, cfg: BagelConfig) -> Dict[str, np.ndarray]:
    """The JAX tree (``bagel.init_params`` or the JAX loader's output, leaves
    as numpy) as a released-name state dict; the VAE subtree is not ported."""
    sd: Dict[str, np.ndarray] = {}
    llm = tree["llm"]
    pre = "language_model.model."
    sd[pre + "embed_tokens.weight"] = np.asarray(llm["embed_tokens"])
    layers = llm["layers"]
    attn_names = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj"}
    for i in range(cfg.llm.num_hidden_layers):
        lp = f"{pre}layers.{i}."
        for key, leaf in layers["attn"].items():
            base, gen = (key[:-4], "_moe_gen") if key.endswith("_gen") else (key, "")
            if base in attn_names:
                _lin(sd, f"{lp}self_attn.{attn_names[base]}{gen}", leaf, i)
            else:  # q_norm / k_norm
                sd[f"{lp}self_attn.{base}{gen}.weight"] = np.asarray(leaf["scale"])[i]
        for key in ("input_layernorm", "post_attention_layernorm",
                    "input_layernorm_moe_gen", "post_attention_layernorm_moe_gen"):
            if key in layers:
                sd[f"{lp}{key}.weight"] = np.asarray(layers[key]["scale"])[i]
        for mlp in ("mlp", "mlp_moe_gen"):
            if mlp in layers:
                for part in ("gate", "up", "down"):
                    _lin(sd, f"{lp}{mlp}.{part}_proj", layers[mlp][part], i)
    sd[pre + "norm.weight"] = np.asarray(llm["norm"]["scale"])
    if "norm_moe_gen" in llm:
        sd[pre + "norm_moe_gen.weight"] = np.asarray(llm["norm_moe_gen"]["scale"])
    sd["language_model.lm_head.weight"] = np.ascontiguousarray(np.asarray(llm["lm_head"]).T)

    if "vit" in tree:
        vit = tree["vit"]
        vp = "vit_model.vision_model."
        _lin(sd, vp + "embeddings.patch_embedding", vit["patch_embedding"])
        if "position_embedding" in vit:
            sd[vp + "embeddings.position_embedding.weight"] = np.asarray(vit["position_embedding"])
        vl = vit["layers"]
        for i in range(cfg.vit.num_hidden_layers):
            lp = f"{vp}encoder.layers.{i}."
            for ln in ("layer_norm1", "layer_norm2"):
                sd[f"{lp}{ln}.weight"] = np.asarray(vl[ln]["scale"])[i]
                sd[f"{lp}{ln}.bias"] = np.asarray(vl[ln]["bias"])[i]
            for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
                _lin(sd, f"{lp}self_attn.{name}", vl["attn"][key], i)
            for key in ("fc1", "fc2"):
                _lin(sd, f"{lp}mlp.{key}", vl["mlp"][key], i)
        sd[vp + "post_layernorm.weight"] = np.asarray(vit["post_layernorm"]["scale"])
        sd[vp + "post_layernorm.bias"] = np.asarray(vit["post_layernorm"]["bias"])
        _lin(sd, "connector.fc1", tree["connector"]["fc1"])
        _lin(sd, "connector.fc2", tree["connector"]["fc2"])
        sd["vit_pos_embed.pos_embed"] = np.asarray(tree["vit_pos_embed"])
    if "vae2llm" in tree:
        _lin(sd, "vae2llm", tree["vae2llm"])
        _lin(sd, "llm2vae", tree["llm2vae"])
        _lin(sd, "time_embedder.mlp.0", tree["time_embedder"]["fc1"])
        _lin(sd, "time_embedder.mlp.2", tree["time_embedder"]["fc2"])
        sd["latent_pos_embed.pos_embed"] = np.asarray(tree["latent_pos_embed"])
    return sd


def _to_torch(a: np.ndarray) -> torch.Tensor:
    # bf16 leaves (ml_dtypes) have no torch counterpart in from_numpy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def from_jax_params(tree: Dict, cfg: BagelConfig, device="cpu",
                    dtype: torch.dtype = torch.float32) -> Bagel:
    """A Bagel holding the JAX tree's weights (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, bagel.init_params(...))``)."""
    sd = jax_tree_to_state_dict(tree, cfg)
    return _build({k: _to_torch(v) for k, v in sd.items()}, cfg, device, dtype)


# ---------------------------------------------------------------------------
# released checkpoint directory
# ---------------------------------------------------------------------------

def _safetensors_files(ckpt_dir: str, prefer_ema: bool) -> Dict[str, str]:
    """key -> file, for a single-file (ema/model.safetensors, ema preferred)
    or sharded (*.safetensors.index.json) checkpoint."""
    from safetensors import safe_open

    for name in ("model.safetensors.index.json", "ema.safetensors.index.json"):
        index = os.path.join(ckpt_dir, name)
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            return {k: os.path.join(ckpt_dir, v) for k, v in weight_map.items()}
    names = ["ema.safetensors", "model.safetensors"]
    for name in names if prefer_ema else names[::-1]:
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            with safe_open(path, framework="pt") as f:
                return {k: path for k in f.keys()}
    raise FileNotFoundError(f"no safetensors found in {ckpt_dir}")


def load_bagel_checkpoint(
    ckpt_dir: str,
    cfg: Optional[BagelConfig] = None,
    device="cpu",
    dtype: torch.dtype = torch.bfloat16,
    prefer_ema: bool = True,
) -> Bagel:
    """Read a released checkpoint directory (``llm_config.json``,
    ``vit_config.json``, ``ema.safetensors`` or ``model.safetensors``, sharded
    or not) into a Bagel on ``device``. The VAE (``ae.safetensors``) belongs to
    the gen slice and is not read."""
    from safetensors import safe_open

    if cfg is None:
        cfg = BagelConfig.from_checkpoint_dir(ckpt_dir)
    files = _safetensors_files(ckpt_dir, prefer_ema)
    wanted = Bagel(cfg, device="meta").state_dict().keys()
    missing = [k for k in wanted if k not in files]
    if missing:
        raise KeyError(f"checkpoint {ckpt_dir} lacks {len(missing)} weights, e.g. {missing[:3]}")
    state: Dict[str, torch.Tensor] = {}
    handles = {}
    try:
        for key in wanted:
            path = files[key]
            if path not in handles:
                handles[path] = safe_open(path, framework="pt").__enter__()
            t = handles[path].get_tensor(key)
            if key.endswith("patch_embedding.weight") and t.dim() == 4:
                t = t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)
            state[key] = t
    finally:
        for h in handles.values():
            h.__exit__(None, None, None)
    return _build(state, cfg, device, dtype)
