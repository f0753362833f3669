"""End-to-end VAE training extras (port of unimedvl_tpu/training/e2e_vae.py;
reference bagel.py:63-88, 122-199). Both are switched on by
``BagelConfig.e2e``:

* **Latent batch-norm**: the reference wraps the VAE latents in a
  ``BatchNorm2d(z_channels, eps=1e-4, affine=False,
  track_running_stats=True)`` (bagel.py:122-135) and applies it in the
  training forward (bagel.py:230-231). Here it is a function with an
  explicit running-stats state (:class:`BatchNormState`) that the train step
  carries. It works on patchified latent tokens [N, p*p*zc]: grouping the
  elements by channel is the same as BatchNorm2d's over the unpatchified
  latent.

* **REPA-style alignment**: cosine alignment between mid-layer diffusion
  features (the ``diffusion_feature_layer`` tap, qwen2_navit.py:1083-1097)
  and a frozen teacher's features ([N, teacher_feature_dim], an input: the
  reference's DINOv2 teacher is not shipped). A learned linear maps the LLM
  hidden (or the latent tokens) to the teacher's width before the cosine.

The port's training forward drops the packed batch's padding rows on the
host (``data.packing.strip_padding``), so the batch statistics are those of
the real latent tokens, as the reference's BatchNorm2d sees them. The JAX
package normalizes the padded [Nv_bucket, p*p*zc] array, whose zero padding
rows enter its statistics; the two agree when the bucket has no padding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from unimedvl_tpu_torch.config import E2EVAEConfig


@dataclasses.dataclass
class BatchNormState:
    """Running statistics of the latent batch-norm (BatchNorm2d with
    ``affine=False``): fp32 [zc] each."""

    mean: torch.Tensor
    var: torch.Tensor

    @classmethod
    def create(cls, z_channels: int, device=None) -> "BatchNormState":
        return cls(mean=torch.zeros(z_channels, dtype=torch.float32, device=device),
                   var=torch.ones(z_channels, dtype=torch.float32, device=device))


def latent_batch_norm(
    tokens: torch.Tensor,  # [N, p*p*zc] patchified latent tokens
    state: BatchNormState,
    z_channels: int,
    training: bool,
    momentum: float = 0.1,
    eps: float = 1e-4,
    valid: Optional[torch.Tensor] = None,  # [N] bool: the real tokens (a padded block)
) -> Tuple[torch.Tensor, BatchNormState]:
    """Normalize latent tokens per z-channel; returns (normed in the tokens'
    dtype, new state). Training: the batch statistics normalize and the
    running stats update as torch does (the running variance takes the
    unbiased batch variance); the new state carries no gradient. Eval: the
    running stats normalize and the state is returned as it was.

    ``valid``: the statistics are taken over those tokens only, their count
    a device value (a padded block's shape does not say it; the padding
    rows are normalized with the real rows' statistics). Without it, over
    every token."""
    N, pd = tokens.shape
    x = tokens.reshape(N * (pd // z_channels), z_channels).float()
    if training and valid is not None:
        w = valid.to(x.dtype).repeat_interleave(pd // z_channels)[:, None]
        n = w.sum()
        mean = (x * w).sum(dim=0) / n.clamp(min=1)
        var = ((x - mean) * w).square().sum(dim=0) / n.clamp(min=1)
        unbiased = var.detach() * n / (n - 1).clamp(min=1)
        new_state = BatchNormState(
            mean=(1 - momentum) * state.mean + momentum * mean.detach(),
            var=(1 - momentum) * state.var + momentum * unbiased,
        )
    elif training:
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        n = x.shape[0]
        unbiased = var.detach() * n / max(n - 1, 1)
        new_state = BatchNormState(
            mean=(1 - momentum) * state.mean + momentum * mean.detach(),
            var=(1 - momentum) * state.var + momentum * unbiased,
        )
    else:
        mean, var = state.mean, state.var
        new_state = state
    y = (x - mean) * torch.rsqrt(var + eps)
    return y.reshape(N, pd).to(tokens.dtype), new_state


def init_repa_params(generator: torch.Generator, hidden_size: int, cfg: E2EVAEConfig,
                     dtype: torch.dtype = torch.float32, device=None) -> nn.Linear:
    """The learned projection hidden -> teacher width, as the JAX package
    draws it: weight uniform in +-1/sqrt(hidden_size) from ``generator``,
    bias zero. Returned as an ``nn.Linear`` ([Dt, hidden] weight)."""
    bound = 1.0 / math.sqrt(hidden_size)
    w = torch.rand((cfg.teacher_feature_dim, hidden_size), generator=generator,
                   dtype=torch.float32, device=generator.device) * (2 * bound) - bound
    lin = nn.Linear(hidden_size, cfg.teacher_feature_dim, device="meta")
    lin.weight = nn.Parameter(w.to(device=device, dtype=dtype))
    lin.bias = nn.Parameter(torch.zeros(cfg.teacher_feature_dim, dtype=dtype, device=device))
    return lin


def repa_alignment_loss(
    diffusion_features: torch.Tensor,  # [N, C] features at the latent tokens
    teacher_features: torch.Tensor,  # [N, Dt] frozen teacher features
    proj: nn.Linear,
    weight: Optional[torch.Tensor] = None,  # [N] optional per-token weight
    alignment_type: str = "cosine",
) -> torch.Tensor:
    """REPA alignment: 1 - cos(proj(h), teacher), the weighted mean over
    tokens, in fp32. The teacher is frozen (detached): gradients reach the
    features and the projection only. ``rsqrt(sum^2 + 1e-12)`` keeps the
    gradient finite on an all-zero row."""
    z = diffusion_features.float() @ proj.weight.float().t() + proj.bias.float()
    t = teacher_features.detach().float()
    if alignment_type == "cosine":
        zn = z * torch.rsqrt(torch.sum(z * z, -1, keepdim=True) + 1e-12)
        tn = t * torch.rsqrt(torch.sum(t * t, -1, keepdim=True) + 1e-12)
        per_tok = 1.0 - torch.sum(zn * tn, dim=-1)
    elif alignment_type == "l2":
        per_tok = torch.mean(torch.square(z - t), dim=-1)
    else:
        raise ValueError(f"alignment_type must be 'cosine' or 'l2', got {alignment_type!r}")
    if weight is None:
        return per_tok.mean()
    w = weight.float()
    return torch.sum(per_tok * w) / torch.clamp(torch.sum(w), min=1.0)
