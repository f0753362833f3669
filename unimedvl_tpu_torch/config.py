"""Typed configuration tree of the port: the port's own copy of
``unimedvl_tpu/config.py``, field for field (tests/test_torch_config.py holds
the two together). The port imports nothing of the JAX package.

Every class is built from keywords or, with ``from_dict``, from a plain dict
of fields as ``dataclasses.asdict`` gives it (nested configs as dicts, tuples
as lists).

Replaces the reference's four config mechanisms (script-level DEFAULT_CONFIG
dicts, checkpoint JSON + hard-coded overrides, PretrainedConfig kwargs, and
data/default.yaml) with one dataclass tree plus readers that stay compatible
with the released checkpoint layout (``llm_config.json`` / ``vit_config.json``).

Reference parity notes:
  * forced overrides at load time mirror the reference
    (interactive_vqa_inferencer.py:206-213): qk_norm=True,
    tie_word_embeddings=False, layer_module="Qwen2MoTDecoderLayer",
    vit rope=False, vit num_hidden_layers -= 1.
  * BagelConfig defaults mirror bagel.py:30-89 and
    interactive_image_generator.py:226-231.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


class _FromDict:
    """Gives a config dataclass a constructor from a plain dict of fields."""

    _nested: dict = {}  # field name -> config class of a nested field

    @classmethod
    def from_dict(cls, d: dict):
        """``cls`` from a plain dict of its fields, as ``dataclasses.asdict``
        gives it: lists become tuples, nested configs are built from their
        dicts (None stays None), and an unknown key raises."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise TypeError(f"{cls.__name__} has no field(s) {unknown}")
        kwargs = {}
        for k, v in d.items():
            if k in cls._nested and isinstance(v, dict):
                v = cls._nested[k].from_dict(v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class LLMConfig(_FromDict):
    """Qwen2 MoT backbone geometry (reference: qwen2_navit.py:46-204)."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = False
    qk_norm: bool = True
    # "Qwen2MoTDecoderLayer" (dual expert attn+mlp), "Qwen2MoEDecoderLayer"
    # (dual mlp only), or "Qwen2DecoderLayer" (dense).
    layer_module: str = "Qwen2MoTDecoderLayer"
    freeze_und: bool = False
    # Explicit per-head dim; None derives hidden_size // num_attention_heads.
    # Needed to express TP-narrowed geometries (heads/TP at the full model's
    # head_dim) for per-chip measurement and for Qwen2 variants whose configs
    # carry an explicit head_dim.
    head_dim_override: Optional[int] = None
    # Per-layer gradient rematerialisation in the training forward: one extra
    # forward of FLOPs for O(1-layer) activation memory. Numerics-neutral;
    # the port's inference paths do not read it.
    remat: bool = True

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @property
    def use_moe(self) -> bool:
        return "Mo" in self.layer_module

    @property
    def mot_attention(self) -> bool:
        """Whether attention projections are duplicated per expert."""
        return self.layer_module == "Qwen2MoTDecoderLayer"

    @classmethod
    def from_json_file(cls, path: str, **overrides) -> "LLMConfig":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        kwargs.update(overrides)
        # Forced overrides matching interactive_vqa_inferencer.py:207-209.
        kwargs["qk_norm"] = True
        kwargs["tie_word_embeddings"] = False
        kwargs["layer_module"] = overrides.get("layer_module", "Qwen2MoTDecoderLayer")
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class ViTConfig(_FromDict):
    """SigLIP NaViT vision encoder (reference: siglip_navit.py:21-99).

    Default geometry = SigLIP-SO400M/14 @ 980px with the last layer dropped
    (interactive_vqa_inferencer.py:212-213 does ``num_hidden_layers -= 1``).
    """

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 26
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 980
    patch_size: int = 14
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6
    rope: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def from_json_file(cls, path: str, **overrides) -> "ViTConfig":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        # Forced overrides matching interactive_vqa_inferencer.py:212-213.
        kwargs["rope"] = False
        if "num_hidden_layers" in raw:
            kwargs["num_hidden_layers"] = raw["num_hidden_layers"] - 1
        kwargs.update(overrides)
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class VAEConfig(_FromDict):
    """FLUX conv VAE (reference: autoencoder.py:20-31, load_ae:337-349)."""

    resolution: int = 256
    in_channels: int = 3
    downsample: int = 8
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    scale_factor: float = 0.3611
    shift_factor: float = 0.1159

    def __post_init__(self):
        # The conv stack downsamples by 2^(len(ch_mult)-1); `downsample` is
        # used for latent-token geometry everywhere else. A mismatch silently
        # produces wrong-sized images, so fail fast.
        actual = 2 ** (len(self.ch_mult) - 1)
        if self.downsample != actual:
            raise ValueError(
                f"VAEConfig.downsample={self.downsample} inconsistent with "
                f"ch_mult={self.ch_mult} (conv stack downsamples {actual}x)"
            )

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)


@dataclasses.dataclass(frozen=True)
class E2EVAEConfig(_FromDict):
    """End-to-end VAE training extras (reference bagel.py:63-88 config block):
    latent batch-norm (running stats, affine=False) and REPA-style feature
    alignment against a pluggable frozen teacher. The reference hardwires a
    DINOv2 teacher; here any callable producing [N, teacher_feature_dim]
    features plugs in (weights for the released teacher are not needed to
    train/test the loss plumbing)."""

    enable_batch_norm: bool = False
    bn_momentum: float = 0.1
    bn_eps: float = 1e-4
    # weight of the mid-layer diffusion-feature alignment term
    repa_diffusion_coeff: float = 0.5
    # weight of the VAE-side alignment term: the (post-BN) latent tokens are
    # projected to teacher dim and cosine-aligned with the teacher, so the
    # alignment gradient reaches the VAE encoder whenever the latents are
    # traced through it (REPA-E style; reference knob bagel.py:69)
    repa_vae_coeff: float = 1.5
    repa_alignment_type: str = "cosine"
    teacher_feature_dim: int = 768
    diffusion_feature_layer: int = 8
    # Deliberately omitted reference knobs (bagel.py:71,83):
    # `vae_perceptual_weight` (default 0.0) and `generation_alignment_coeff`
    # are defined by the reference config but never consumed by any released
    # forward — carrying dead fields here would invite silent misconfiguration.


@dataclasses.dataclass(frozen=True)
class BagelConfig(_FromDict):
    """Unified model tying LLM + ViT + VAE (reference: bagel.py:30-89)."""

    _nested = {"llm": LLMConfig, "vit": ViTConfig, "vae": VAEConfig, "e2e": E2EVAEConfig}

    llm: LLMConfig = dataclasses.field(default_factory=LLMConfig)
    vit: Optional[ViTConfig] = dataclasses.field(default_factory=ViTConfig)
    vae: Optional[VAEConfig] = dataclasses.field(default_factory=VAEConfig)
    visual_gen: bool = True
    visual_und: bool = True
    latent_patch_size: int = 2
    max_latent_size: int = 64
    vit_max_num_patch_per_side: int = 70
    connector_act: str = "gelu_pytorch_tanh"
    interpolate_pos: bool = False
    timestep_shift: float = 1.0
    # e2e-VAE training extras; None = disabled (reference enable_e2e_vae=False)
    e2e: Optional[E2EVAEConfig] = None

    @property
    def latent_downsample(self) -> int:
        """Pixels per latent token side (bagel.py:110): vae downsample x patch."""
        return self.vae.downsample * self.latent_patch_size

    @property
    def latent_channel(self) -> int:
        return self.vae.z_channels

    @property
    def patch_latent_dim(self) -> int:
        """Per-token VAE latent dim (bagel.py:113): p^2 * z_channels = 64."""
        return self.latent_patch_size**2 * self.vae.z_channels

    @classmethod
    def from_checkpoint_dir(cls, ckpt_dir: str, **overrides) -> "BagelConfig":
        llm = LLMConfig.from_json_file(os.path.join(ckpt_dir, "llm_config.json"))
        vit_path = os.path.join(ckpt_dir, "vit_config.json")
        vit = ViTConfig.from_json_file(vit_path) if os.path.exists(vit_path) else None
        kwargs = dict(
            llm=llm,
            vit=vit,
            vae=VAEConfig(),
            latent_patch_size=2,
            max_latent_size=64,
            vit_max_num_patch_per_side=70,
        )
        kwargs.update(overrides)
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class GenerationConfig(_FromDict):
    """Inference-time knobs (reference defaults: inferencer.py:165-178,552-568)."""

    max_length: int = 500
    do_sample: bool = False
    temperature: float = 1.0
    # image generation
    num_timesteps: int = 50
    timestep_shift: float = 3.0
    cfg_text_scale: float = 3.0
    cfg_img_scale: float = 1.5
    cfg_interval: Tuple[float, float] = (0.4, 1.0)
    cfg_renorm_min: float = 0.0
    cfg_renorm_type: str = "global"  # "global" | "channel" | "text_channel"


@dataclasses.dataclass(frozen=True)
class TransformConfig(_FromDict):
    """Image transform geometry (reference: data/default.yaml + scripts).

    vit VQA default (eval/vlm/utils.py:486-502 reading default.yaml vlm_sft):
    980/378/stride14/max_pixels 2_007_040.
    Interactive generator (interactive_image_generator.py:66-67,249-250):
    vae = ImageTransform(1024, 32, 16), vit = ImageTransform(980, 387, 14),
    both with ImageTransform's default max_pixels = 14*14*9*1024 = 1_806_336
    (transforms.py:96).
    """

    max_size: int = 980
    min_size: int = 378
    stride: int = 14
    max_pixels: int = 2_007_040

    @classmethod
    def vit_vqa(cls) -> "TransformConfig":
        return cls(max_size=980, min_size=378, stride=14, max_pixels=2_007_040)

    @classmethod
    def vit_interactive(cls) -> "TransformConfig":
        return cls(max_size=980, min_size=387, stride=14, max_pixels=14 * 14 * 9 * 1024)

    @classmethod
    def vae_interactive(cls) -> "TransformConfig":
        return cls(max_size=1024, min_size=32, stride=16, max_pixels=14 * 14 * 9 * 1024)
