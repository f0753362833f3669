"""FLUX conv VAE (port of unimedvl_tpu/models/vae.py; reference
autoencoder.py): encoder, decoder, the diagonal-Gaussian sample and the
scale/shift of the latent.

NCHW ``nn.Module``s under the names of the released ``ae.safetensors``
(``encoder.down.{i}.block.{j}.norm1.weight``, ``decoder.up.{i}.upsample.conv``
...). Convolutions compute in their input's dtype, as the JAX package's do
(it casts each kernel to the input's dtype): the pipeline feeds fp32 images
and latents, so the VAE runs in fp32. GroupNorm statistics are fp32
(ops/norms.py). The JAX VAE has no Pallas kernel; here the convolutions are
cuDNN's and the mid-block attention is a plain fp32 softmax.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unimedvl_tpu_torch.config import VAEConfig
from unimedvl_tpu_torch.ops.activations import swish
from unimedvl_tpu_torch.ops.norms import group_norm


class Conv2d(nn.Conv2d):
    """A convolution in its input's dtype; weights are left for a loader or
    ``init_random_`` to fill."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, device=None):
        super().__init__(cin, cout, kernel, stride, padding, device="meta", dtype=torch.float32)
        self.to_empty(device=device if device is not None else "cpu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                        self.padding)


class GroupNorm(nn.Module):
    """GroupNorm(32, eps=1e-6) with fp32 statistics."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight.to(x.dtype), self.bias.to(x.dtype), 32, 1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.norm1 = GroupNorm(cin, device)
        self.conv1 = Conv2d(cin, cout, 3, padding=1, device=device)
        self.norm2 = GroupNorm(cout, device)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, device=device)
        if cin != cout:
            self.nin_shortcut = Conv2d(cin, cout, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W positions (autoencoder.py:38-65),
    fp32 logits and softmax, probabilities rounded to v's dtype."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.norm = GroupNorm(c, device)
        self.q = Conv2d(c, c, 1, device=device)
        self.k = Conv2d(c, c, 1, device=device)
        self.v = Conv2d(c, c, 1, device=device)
        self.proj_out = Conv2d(c, c, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).reshape(n, c, h * w) for m in (self.q, self.k, self.v))
        logits = torch.einsum("ncq,nck->nqk", q.float(), k.float()) / math.sqrt(c)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("nqk,nck->ncq", attn, v).reshape(n, c, h, w)
        return x + self.proj_out(o)


class Downsample(nn.Module):
    """Pad right and bottom by one, then a stride-2 3x3 conv (autoencoder.py:98-108)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest-neighbour 2x, then a 3x3 conv (autoencoder.py:111-119)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Level(nn.Module):
    """One resolution level: ``block`` and an optional ``downsample`` or ``upsample``."""

    def __init__(self, blocks):
        super().__init__()
        self.block = nn.ModuleList(blocks)


class _Mid(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.block_1 = ResnetBlock(c, c, device)
        self.attn_1 = AttnBlock(c, device)
        self.block_2 = ResnetBlock(c, c, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    """[N, 3, H, W] -> [N, 2z, H/8, W/8] moments (autoencoder.py:122-187)."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, padding=1, device=device)
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        self.down = nn.ModuleList()
        block_in = cfg.ch
        for i in range(cfg.num_resolutions):
            block_in = cfg.ch * in_ch_mult[i]
            block_out = cfg.ch * cfg.ch_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out, device))
                block_in = block_out
            level = _Level(blocks)
            if i != cfg.num_resolutions - 1:
                level.downsample = Downsample(block_in, device)
            self.down.append(level)
        self.mid = _Mid(block_in, device)
        self.norm_out = GroupNorm(block_in, device)
        self.conv_out = Conv2d(block_in, 2 * cfg.z_channels, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    """[N, z, h, w] -> [N, 3, 8h, 8w] (autoencoder.py:190-257)."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1, device=device)
        self.mid = _Mid(block_in, device)
        up = [None] * cfg.num_resolutions
        for i in reversed(range(cfg.num_resolutions)):
            block_out = cfg.ch * cfg.ch_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, device))
                block_in = block_out
            level = _Level(blocks)
            if i != 0:
                level.upsample = Upsample(block_in, device)
            up[i] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in, device)
        self.conv_out = Conv2d(block_in, cfg.out_ch, 3, padding=1, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


class AutoEncoder(nn.Module):
    """The FLUX VAE, fp32 parameters, inference only."""

    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        self.requires_grad_(False)

    @torch.no_grad()
    def encode_moments(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [N, 3, H, W] in [-1, 1] -> (mean, logvar), each [N, z, H/8, W/8]."""
        mean, logvar = torch.chunk(self.encoder(images), 2, dim=1)
        return mean, logvar

    @torch.no_grad()
    def encode(self, images: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scaled latent (autoencoder.py:300-303): the posterior sample
        mean + exp(logvar / 2) * noise (noise: standard normal, shaped like
        the mean), or the mean when ``noise`` is None."""
        mean, logvar = self.encode_moments(images)
        z = mean
        if noise is not None:
            std = torch.exp(0.5 * logvar.float()).to(mean.dtype)
            z = mean + std * noise.to(mean.dtype)
        return self.cfg.scale_factor * (z - self.cfg.shift_factor)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent [N, z, h, w] -> image [N, 3, 8h, 8w] in [-1, 1]
        (autoencoder.py:305-307)."""
        return self.decoder(z / self.cfg.scale_factor + self.cfg.shift_factor)
