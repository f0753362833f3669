"""Weights into a :class:`~unimedvl_tpu_torch.models.bagel.Bagel` (port of
unimedvl_tpu/weights/bagel_loader.py and vae_loader.py).

The port's parameter names are the released checkpoint's, and torch Linear
weights are [out, in] as released, so ``load_bagel_checkpoint`` reads each
tensor by name with no transpose. Two conversions remain, as in the JAX
loader: the ViT conv patch embedding [C, 3, p, p] becomes its linear form
[C, p*p*3] (siglip_navit.py:176-179), and the checkpoint's last ViT layer is
dropped (``ViTConfig.from_json_file`` already counts one layer fewer).

``from_jax_params`` builds the same model from the JAX package's parameter
tree (numpy leaves), so both packages compute one function in the tests. It
takes the JAX package's quantized and fused trees too
(``quant.quantize_llm_params``, ``quant.fuse_serving_projections``): every leaf
form (``kernel_q``, ``kernel_qa``, ``kernel_p4``, ``kernel_p4a``; per-channel
and [G, N] scales; fused ``qkv``, ``qkv_gen``, ``gate_up`` and their
shard-interleaved ``_tp{N}`` variants, whose column order is kept) becomes the port's
``QuantLinear`` with the same integers and scales, and its LoRA adapter leaves
(``lora_a`` [L, in, r], ``lora_b`` [L, r, out], ``lora_s`` [L]) become
``LoRALinear``s per layer, over a bf16 or a quantized base (QLoRA). JAX leaves are [in, out],
packed along in; the port's are [out, in], packed along in: one transposition
here, of bytes, which leaves each byte's two nibbles as they were.

``load_bagel_checkpoint(quantize_bits=...)`` quantizes each LLM projection as
it is read, so the bf16 LLM is never whole on the device.

The FLUX VAE ships apart as ``ae.safetensors``, whose names the port's
``AutoEncoder`` keeps (OIHW convolutions, as released): ``load_ae`` reads it
with no conversion, and the Bagel holds it as ``vae_model``, in fp32.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from unimedvl_tpu_torch import quant
from unimedvl_tpu_torch.config import BagelConfig, VAEConfig
from unimedvl_tpu_torch.models.bagel import Bagel
from unimedvl_tpu_torch.models.layers import LoRALinear, QuantLinear
from unimedvl_tpu_torch.models.vae import AutoEncoder

_VAE = "vae_model."


# QuantLinear buffers and the adapters' fp32 scale keep their own dtypes
_KEEP_DTYPE_SUFFIXES = (".weight_q", ".scale", ".lora_s")


def _build(state: Dict[str, torch.Tensor], cfg: BagelConfig, device, dtype,
           quant_modes: Optional[Dict[str, str]] = None, fused_tp: int = 0,
           prepare=None) -> Bagel:
    """A Bagel around ``state``. ``quant_modes``: module path -> mode of
    every quantized linear in ``state`` (its ``weight_q`` and ``scale`` shape
    the leaf); ``fused_tp``: the LLM's q/k/v and gate/up are fused leaves of
    that shard degree (1: plain; 0: not fused); ``prepare``: called with the
    model before the state is assigned (a mesh rank's module swaps)."""
    with_vae = any(k.startswith(_VAE) for k in state)
    model = Bagel(cfg, device="meta", dtype=dtype, with_vae=with_vae)
    if fused_tp:
        quant.fuse_serving_projections(model.language_model, tp=fused_tp)
    for path, mode in (quant_modes or {}).items():
        model.set_submodule(path, QuantLinear(
            mode, state[path + ".weight_q"], state[path + ".scale"], state.get(path + ".bias")))
    for key in [k for k in state if k.endswith(".lora_a")]:
        path = key[: -len(".lora_a")]
        model.set_submodule(path, LoRALinear(
            model.get_submodule(path), state[key], state[path + ".lora_b"],
            float(state[path + ".lora_s"])))

    def placed(k, v):
        if k.endswith(_KEEP_DTYPE_SUFFIXES):
            return v.to(device=device)
        return v.to(device=device, dtype=torch.float32 if k.startswith(_VAE) else dtype)

    if prepare is not None:
        prepare(model)
    state = {k: placed(k, v) for k, v in state.items()}
    model.load_state_dict(state, strict=True, assign=True)  # keeps requires_grad=False
    return model


# ---------------------------------------------------------------------------
# JAX parameter tree -> released names
# ---------------------------------------------------------------------------

_JAX_QUANT_LEAVES = {"kernel_q": "q", "kernel_qa": "qa", "kernel_p4": "p4", "kernel_p4a": "p4a"}
_TP_SUFFIX = re.compile(r"^(.*)_tp(\d+)$")


def _split_tp(key: str):
    """A JAX leaf name without its shard-degree marker: ``qkv_gen_tp2`` ->
    (``qkv_gen``, ``_tp2``); other names -> (name, "")."""
    m = _TP_SUFFIX.match(key)
    return (m.group(1), f"_tp{m.group(2)}") if m else (key, "")


def _lin(sd, name, p, i=None, quant_modes=None):
    """One JAX linear leaf (layer ``i`` of a stacked one) under the released
    name: ``.weight`` [out, in], or for a quantized leaf ``.weight_q`` (the
    [in(/2), out] integers transposed) and ``.scale`` ([out] or [G, out], as
    it is), with its mode noted in ``quant_modes``."""
    pick = (lambda a: a[i]) if i is not None else (lambda a: a)
    if isinstance(p, dict) and "kernel" in p:
        sd[name + ".weight"] = np.ascontiguousarray(pick(np.asarray(p["kernel"])).T)
    else:
        key = next((k for k in _JAX_QUANT_LEAVES if k in p), None)
        if key is None:
            raise KeyError(f"{name}: no kernel leaf in {sorted(p)}")
        sd[name + ".weight_q"] = np.ascontiguousarray(pick(np.asarray(p[key])).T)
        sd[name + ".scale"] = np.ascontiguousarray(pick(np.asarray(p["scale"])))
        quant_modes[name] = _JAX_QUANT_LEAVES[key]
    if "bias" in p:
        sd[name + ".bias"] = pick(np.asarray(p["bias"]))
    if "lora_a" in p:  # adapter leaves [in, r], [r, out] -> [r, in], [out, r]; lora_s per layer
        sd[name + ".lora_a"] = np.ascontiguousarray(pick(np.asarray(p["lora_a"])).T)
        sd[name + ".lora_b"] = np.ascontiguousarray(pick(np.asarray(p["lora_b"])).T)
        sd[name + ".lora_s"] = np.asarray(pick(np.asarray(p["lora_s"])), np.float32)


def _vae_state_dict(sd, vae: Dict, cfg: VAEConfig, prefix: str = "") -> None:
    """The JAX VAE subtree (HWIO kernels) under the released ae.safetensors
    names (OIHW), inverting vae_loader.convert_vae_state_dict."""

    def conv(name, p):
        sd[prefix + name + ".weight"] = np.ascontiguousarray(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
        )
        sd[prefix + name + ".bias"] = np.asarray(p["bias"])

    def norm(name, p):
        sd[prefix + name + ".weight"] = np.asarray(p["scale"])
        sd[prefix + name + ".bias"] = np.asarray(p["bias"])

    def resnet(name, p):
        for key in ("norm1", "norm2"):
            norm(f"{name}.{key}", p[key])
        for key in ("conv1", "conv2", "nin_shortcut"):
            if key in p:
                conv(f"{name}.{key}", p[key])

    def mid(name, p):
        resnet(name + ".block_1", p["block_1"])
        resnet(name + ".block_2", p["block_2"])
        norm(name + ".attn_1.norm", p["attn_1"]["norm"])
        for key in ("q", "k", "v", "proj_out"):
            conv(f"{name}.attn_1.{key}", p["attn_1"][key])

    for part, levels, resample in (("encoder", "down", "downsample"),
                                   ("decoder", "up", "upsample")):
        tree = vae[part]
        conv(part + ".conv_in", tree["conv_in"])
        for i, level in enumerate(tree[levels]):
            for j, block in enumerate(level["block"]):
                resnet(f"{part}.{levels}.{i}.block.{j}", block)
            if resample in level:
                conv(f"{part}.{levels}.{i}.{resample}.conv", level[resample]["conv"])
        mid(part + ".mid", tree["mid"])
        norm(part + ".norm_out", tree["norm_out"])
        conv(part + ".conv_out", tree["conv_out"])


def jax_tree_to_state_dict(tree: Dict, cfg: BagelConfig, quant_modes: Optional[Dict] = None
                           ) -> Dict[str, np.ndarray]:
    """The JAX tree (``bagel.init_params`` or the JAX loader's output, leaves
    as numpy) as a released-name state dict; its VAE, if it has one, under
    ``vae_model.``. Quantized leaves come as ``.weight_q`` and ``.scale`` with
    their modes in ``quant_modes`` (path -> mode), fused leaves as
    ``qkv_proj``, ``qkv_proj_moe_gen`` and ``gate_up_proj``, with ``_tp{N}``
    after ``_proj`` for the shard-interleaved ones."""
    sd: Dict[str, np.ndarray] = {}
    quant_modes = {} if quant_modes is None else quant_modes
    llm = tree["llm"]
    pre = "language_model.model."
    sd[pre + "embed_tokens.weight"] = np.asarray(llm["embed_tokens"])
    layers = llm["layers"]
    attn_names = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj", "qkv": "qkv_proj"}
    for i in range(cfg.llm.num_hidden_layers):
        lp = f"{pre}layers.{i}."
        for key, leaf in layers["attn"].items():
            key, tp_tag = _split_tp(key)  # qkv_gen_tp2 -> qkv_proj_tp2_moe_gen
            base, gen = (key[:-4], "_moe_gen") if key.endswith("_gen") else (key, "")
            if base in attn_names:
                _lin(sd, f"{lp}self_attn.{attn_names[base]}{tp_tag}{gen}", leaf, i, quant_modes)
            else:  # q_norm / k_norm
                sd[f"{lp}self_attn.{base}{gen}.weight"] = np.asarray(leaf["scale"])[i]
        for key in ("input_layernorm", "post_attention_layernorm",
                    "input_layernorm_moe_gen", "post_attention_layernorm_moe_gen"):
            if key in layers:
                sd[f"{lp}{key}.weight"] = np.asarray(layers[key]["scale"])[i]
        for mlp in ("mlp", "mlp_moe_gen"):
            if mlp in layers:
                for part, leaf in layers[mlp].items():
                    part, tp_tag = _split_tp(part)  # gate_up_tp2 -> gate_up_proj_tp2
                    _lin(sd, f"{lp}{mlp}.{part}_proj{tp_tag}", leaf, i, quant_modes)
    sd[pre + "norm.weight"] = np.asarray(llm["norm"]["scale"])
    if "norm_moe_gen" in llm:
        sd[pre + "norm_moe_gen.weight"] = np.asarray(llm["norm_moe_gen"]["scale"])
    head = llm["lm_head"]  # a bare [C, V] kernel, or a quantized leaf
    _lin(sd, "language_model.lm_head", head if isinstance(head, dict) else {"kernel": head},
         None, quant_modes)

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
    for name in ("repa_proj", "repa_vae_proj"):  # the e2e-VAE extras' projections
        if name in tree:
            _lin(sd, name, tree[name]["proj"])
    if "vae" in tree:
        _vae_state_dict(sd, tree["vae"], cfg.vae, _VAE)
    return sd


def _to_torch(a: np.ndarray) -> torch.Tensor:
    # bf16 leaves (ml_dtypes) have no torch counterpart in from_numpy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def from_jax_params(tree: Dict, cfg: BagelConfig, device="cuda",
                    dtype: torch.dtype = torch.float32, mesh=None) -> Bagel:
    """A Bagel holding the JAX tree's weights (numpy leaves, e.g.
    ``jax.tree.map(np.asarray, bagel.init_params(...))``), bf16 or quantized,
    fused or not, with or without LoRA adapters, as the tree is. Like the
    other loaders it places the model on the card unless the caller names
    another device, and raises when there is none. ``mesh``: this rank's
    shard of a ``parallel.mesh.Mesh`` (``parallel.mesh.place_params``'s
    model), with only the rank's part of each sharded leaf moved to
    ``device``."""
    from unimedvl_tpu_torch.parallel import mesh as pmesh

    device = _target_device(device)
    quant_modes: Dict[str, str] = {}
    sd = jax_tree_to_state_dict(tree, cfg, quant_modes)
    if mesh is not None:
        state = pmesh.shard_state({k: _to_torch(v) for k, v in sd.items()}, cfg.llm, mesh)
        return pmesh.build_rank_model({k: v.contiguous() for k, v in state.items()}, cfg, mesh,
                                      device, dtype, quant_modes)
    return _build({k: _to_torch(v) for k, v in sd.items()}, cfg, device, dtype,
                  quant_modes, pmesh.fused_degree(sd))



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


def _read_ae(path: str) -> Dict[str, torch.Tensor]:
    """ae.safetensors as a state dict, without the ``module.`` prefix a DDP
    save adds (autoencoder.py:356)."""
    from safetensors.torch import load_file

    return {k.replace("module.", ""): v for k, v in load_file(path).items()}


def _target_device(device) -> torch.device:
    """``device`` as a torch.device. The loaders place a model on the card
    unless the caller names another device; without a card that default
    raises, it does not fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available; pass device=\"cpu\" to "
            "load on the host (every kernel wrapper then takes its plain version)"
        )
    return device


def load_ae(path: str, cfg: Optional[VAEConfig] = None, device="cuda") -> AutoEncoder:
    """Read a released ``ae.safetensors`` into an fp32 AutoEncoder on
    ``device``: the card unless the caller names another (the counterpart of
    unimedvl_tpu/weights/vae_loader.load_ae)."""
    device = _target_device(device)
    model = AutoEncoder(cfg or VAEConfig(), device="meta")
    state = {k: v.to(device=device, dtype=torch.float32) for k, v in _read_ae(path).items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model


def load_bagel_checkpoint(
    ckpt_dir: str,
    cfg: Optional[BagelConfig] = None,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    prefer_ema: bool = True,
    quantize_bits: Optional[int] = None,
    act_quant: bool = False,
    quantize_group: int = 0,
    base_dir: Optional[str] = None,
    mesh=None,
) -> Bagel:
    """Read a released checkpoint directory (``llm_config.json``,
    ``vit_config.json``, ``ema.safetensors`` or ``model.safetensors``, sharded
    or not) into a Bagel on ``device``: the card unless the caller names
    another, and an error when there is none. The VAE is read from
    ``ae.safetensors`` when the directory has one and the config generates
    images.

    ``quantize_bits`` (8 or 4): quantize the LLM's projections and lm_head as
    ``quant.quantize_llm_params`` does, each weight as it is read and placed
    on ``device``, so the bf16 LLM is never whole there; ``act_quant`` marks
    the leaves for integer matmuls; ``quantize_group``: group-wise w4 scales.
    The result equals quantizing after a plain load. Fuse afterwards with
    ``quant.fuse_serving_projections(model.language_model)``.

    ``base_dir``: a base checkpoint merged under the fine-tune in
    ``ckpt_dir``, whose keys win (reference eval/vlm/utils.py:281-317; the
    JAX package's ``MergedReader``); the VAE still comes from ``ckpt_dir``.

    ``mesh``: a ``parallel.mesh.Mesh`` with a "model" axis; every rank of it
    calls this and gets its shard (``parallel.mesh.place_params``'s model):
    each tensor the mesh shards is read as the rank's ranges of it
    (``safe_open(...).get_slice``), so no rank holds a whole sharded tensor
    on the host or on the device. Quantizing a row-parallel projection's
    shard per channel takes the whole row's absmax (an all-reduce-max over
    "model"): every rank holds its part of the whole model's quantized
    weights."""
    from safetensors import safe_open

    from unimedvl_tpu_torch.parallel import mesh as pmesh

    device = _target_device(device)
    if cfg is None:
        cfg = BagelConfig.from_checkpoint_dir(ckpt_dir)
    if quantize_bits is None and (act_quant or quantize_group):
        raise ValueError("act_quant and quantize_group need quantize_bits")
    files = _safetensors_files(ckpt_dir, prefer_ema)
    if base_dir is not None:  # the fine-tune's keys win
        files = {**_safetensors_files(base_dir, prefer_ema), **files}
    wanted = Bagel(cfg, device="meta").state_dict().keys()
    missing = [k for k in wanted if k not in files]
    if missing:
        raise KeyError(f"checkpoint {ckpt_dir} lacks {len(missing)} weights, e.g. {missing[:3]}")
    state: Dict[str, torch.Tensor] = {}
    quant_modes: Dict[str, str] = {}
    handles = {}
    tp = 1 if mesh is None else mesh.shape.get("model", 1)
    rank = 0 if mesh is None else mesh.coords.get("model", 0)
    row_reduce = None
    if tp > 1:
        import functools

        import torch.distributed as dist

        row_reduce = functools.partial(mesh.all_reduce, axis="model", op=dist.ReduceOp.MAX)
    try:
        for key in wanted:
            path = files[key]
            if path not in handles:
                handles[path] = safe_open(path, framework="pt").__enter__()
            if mesh is None:
                t = handles[path].get_tensor(key)
            else:
                sl = handles[path].get_slice(key)
                t = _read_ranges(sl, pmesh.leaf_ranges(key, sl.get_shape(), cfg.llm, tp, rank))
            if key.endswith("patch_embedding.weight") and t.dim() == 4:
                t = t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)
            module = key[: -len(".weight")]
            if quantize_bits is not None and _is_quantized_weight(key):
                head = module == "language_model.lm_head"  # int8 whatever the bits
                bits, group = (8, 0) if head else (quantize_bits, quantize_group)
                row = module.endswith(("o_proj", "o_proj_moe_gen", "down_proj"))
                q, scale = quant.quantize_weight(t.to(device=device, dtype=dtype), bits, group,
                                                 row_reduce if row else None)
                state[module + ".weight_q"], state[module + ".scale"] = q, scale
                quant_modes[module] = quant.mode_name(bits, act_quant)
            else:
                state[key] = t
    finally:
        for h in handles.values():
            h.__exit__(None, None, None)
    ae_path = os.path.join(ckpt_dir, "ae.safetensors")
    if cfg.visual_gen and cfg.vae is not None and os.path.exists(ae_path):
        state.update({_VAE + k: v for k, v in _read_ae(ae_path).items()})
    if mesh is not None:
        return pmesh.build_rank_model(state, cfg, mesh, device, dtype, quant_modes)
    return _build(state, cfg, device, dtype, quant_modes)


def _read_ranges(sl, ranges) -> torch.Tensor:
    """A safetensors slice's ``ranges`` (``parallel.mesh.leaf_ranges``; None:
    the whole tensor), read from the file and nothing else."""
    if ranges is None:
        return sl[:]
    dim, parts = ranges
    if dim == 0:
        pieces = [sl[a:a + n] for a, n in parts]
    else:
        pieces = [sl[:, a:a + n] for a, n in parts]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=dim)


def _is_quantized_weight(key: str) -> bool:
    """Whether ``quant.quantize_llm_params`` quantizes this released weight:
    the decoder layers' attention and MLP projections of both experts, and
    the lm_head."""
    if key == "language_model.lm_head.weight":
        return True
    if not key.startswith("language_model.model.layers.") or not key.endswith(".weight"):
        return False
    leaf = key.split(".")[-2]
    return any(leaf == k + sfx for k in quant.QUANT_KEYS for sfx in quant.EXPERTS)
