"""Host-side image preprocessing (the port's own copy of
``unimedvl_tpu/data/imaging.py``): the reference's pure-function semantics
with NumPy and PIL instead of torchvision.

Parity sources:
  * resize math: MaxLongEdgeMinShortEdgeResize (transforms.py:15-87)
  * normalize: ImageTransform mean/std 0.5 (transforms.py:90-115)
  * patchify: data_utils.py:43-50 (einsum chpwq->hwpqc)
  * position ids: data_utils.py:53-69
  * RGBA flattening: data_utils.py:116-137
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image


def _make_divisible(value: float, stride: int) -> int:
    """transforms.py:49-51 — round to the nearest multiple, floor at stride.

    Uses Python's banker's rounding, exactly like the reference.
    """
    return max(stride, int(round(value / stride) * stride))


def _apply_scale(width: int, height: int, scale: float, stride: int) -> Tuple[int, int]:
    new_width = round(width * scale)
    new_height = round(height * scale)
    return _make_divisible(new_width, stride), _make_divisible(new_height, stride)


def compute_resize_shape(
    width: int,
    height: int,
    max_size: int,
    min_size: int,
    stride: int,
    max_pixels: int,
    img_num: int = 1,
) -> Tuple[int, int]:
    """(new_width, new_height) under the reference's constraints
    (transforms.py:60-87): longest edge <= max_size, shortest edge >= min_size,
    both divisible by stride, total pixels <= max_pixels / img_num.
    """
    scale = min(max_size / max(width, height), 1.0)
    scale = max(scale, min_size / min(width, height))
    new_width, new_height = _apply_scale(width, height, scale, stride)

    if new_width * new_height > max_pixels / img_num:
        scale = max_pixels / img_num / (new_width * new_height)
        new_width, new_height = _apply_scale(new_width, new_height, scale, stride)

    if max(new_width, new_height) > max_size:
        scale = max_size / max(new_width, new_height)
        new_width, new_height = _apply_scale(new_width, new_height, scale, stride)

    return new_width, new_height


def pil_img2rgb(image: Image.Image) -> Image.Image:
    """Flatten alpha onto white, convert to RGB (data_utils.py:116-137)."""
    width, height = image.size
    if width * height > 20_000_000:
        raise ValueError(f"Image too large: {width * height} pixels")
    if image.mode == "RGBA" or image.info.get("transparency", None) is not None:
        image = image.convert("RGBA")
        white = Image.new(mode="RGB", size=image.size, color=(255, 255, 255))
        white.paste(image, mask=image.split()[3])
        return white
    return image.convert("RGB")


class ResizeTransform:
    """PIL bicubic resize to the constrained shape (transforms.py:15-87).

    PIL's resize is inherently antialiased for downscale with BICUBIC,
    matching torchvision's antialias=True PIL path.
    """

    def __init__(self, max_size: int, min_size: int, stride: int, max_pixels: int):
        self.max_size = max_size
        self.min_size = min_size
        self.stride = stride
        self.max_pixels = max_pixels

    def __call__(self, img: Image.Image, img_num: int = 1) -> Image.Image:
        w, h = img.size
        new_w, new_h = compute_resize_shape(
            w, h, self.max_size, self.min_size, self.stride, self.max_pixels, img_num
        )
        return img.resize((new_w, new_h), resample=Image.BICUBIC)


class ImageTransform:
    """resize -> [0,1] float -> normalize(mean=std=0.5) -> CHW float32 numpy.

    Mirrors transforms.py:90-115. Returns numpy (host) arrays.
    """

    def __init__(
        self,
        max_image_size: int,
        min_image_size: int,
        image_stride: int,
        max_pixels: int = 14 * 14 * 9 * 1024,
        image_mean=(0.5, 0.5, 0.5),
        image_std=(0.5, 0.5, 0.5),
    ):
        self.stride = image_stride
        self.resize_transform = ResizeTransform(
            max_image_size, min_image_size, image_stride, max_pixels
        )
        self.mean = np.asarray(image_mean, dtype=np.float32).reshape(3, 1, 1)
        self.std = np.asarray(image_std, dtype=np.float32).reshape(3, 1, 1)

    def __call__(self, img: Image.Image, img_num: int = 1) -> np.ndarray:
        img = self.resize_transform(img, img_num=img_num)
        arr = np.asarray(img, dtype=np.float32) / 255.0  # HWC
        arr = arr.transpose(2, 0, 1)  # CHW
        return (arr - self.mean) / self.std


def patchify(image_chw: np.ndarray, patch_size: int) -> np.ndarray:
    """[C,H,W] -> [H/p * W/p, p*p*C] with chpwq->hwpqc ordering
    (data_utils.py:43-50)."""
    p = patch_size
    c, h, w = image_chw.shape
    assert h % p == 0 and w % p == 0, (h, w, p)
    x = image_chw.reshape(c, h // p, p, w // p, p)
    x = np.einsum("chpwq->hwpqc", x)
    return x.reshape(-1, p * p * c)


def position_ids_extrapolate(
    img_h: int, img_w: int, patch_size: int, max_num_patches_per_side: int
) -> np.ndarray:
    """Raster position ids row*max_side + col (data_utils.py:53-58)."""
    nh, nw = img_h // patch_size, img_w // patch_size
    rows = np.arange(nh)[:, None] * max_num_patches_per_side
    return (rows + np.arange(nw)).flatten().astype(np.int64)


def position_ids_interpolate(
    img_h: int, img_w: int, patch_size: int, max_num_patches_per_side: int
) -> np.ndarray:
    """Bucketized fractional ids (data_utils.py:61-69).

    The bucket assignment at exact boundary ties depends on torch.arange's
    fp32 rounding, so this uses torch, as the reference does.
    """
    import torch

    nh, nw = img_h // patch_size, img_w // patch_size
    mx = max_num_patches_per_side
    boundaries = torch.arange(1 / mx, 1.0, 1 / mx)
    frac_h = torch.arange(0, 1 - 1e-6, 1 / nh)
    frac_w = torch.arange(0, 1 - 1e-6, 1 / nw)
    bucket_h = torch.bucketize(frac_h, boundaries, right=True)
    bucket_w = torch.bucketize(frac_w, boundaries, right=True)
    pos_ids = (bucket_h[:, None] * mx + bucket_w).flatten()
    return pos_ids.numpy().astype(np.int64)


def unpatchify_latent(
    latent_tokens: np.ndarray, h: int, w: int, patch_size: int, channels: int
) -> np.ndarray:
    """[h*w, p*p*c] -> [c, h*p, w*p] — inverse of the VAE-latent patchify
    (inferencer.py:239-241 einsum nhwpqc->nchpwq)."""
    p = patch_size
    x = latent_tokens.reshape(h, w, p, p, channels)
    x = np.einsum("hwpqc->chpwq", x)
    return x.reshape(channels, h * p, w * p)
