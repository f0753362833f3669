"""Training-only image degradations for restoration/editing tasks (a copy of
unimedvl_tpu/data/degradations.py: host-side PIL and numpy, nothing of JAX).

Host-side PIL/cv2 reimplementation of reference data/transforms.py:118-263:
decolorization, downscale, crop, motion blur, patch shuffle, inpainting masks.
Randomness is taken from an explicit ``random.Random`` instance for
reproducibility (the reference uses the global ``random``).
"""

from __future__ import annotations

import random as _random
from typing import Optional, Tuple

import numpy as np
from PIL import Image

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def decolorization(image: Image.Image) -> Image.Image:
    """transforms.py:118-120."""
    gray = image.convert("L")
    return Image.merge(image.mode, [gray] * 3) if image.mode in ("RGB", "L") else gray


def downscale(image: Image.Image, scale_factor: float) -> Image.Image:
    """transforms.py:123-128."""
    new_w = max(1, int(round(image.width * scale_factor)))
    new_h = max(1, int(round(image.height * scale_factor)))
    return image.resize((new_w, new_h), resample=Image.BICUBIC)


def crop(
    image: Image.Image,
    crop_factors: Tuple[int, int],
    rng: Optional[_random.Random] = None,
):
    """transforms.py:131-141. Returns (cropped, [[x0,y0],[x1,y1]])."""
    rng = rng or _random
    target_h, target_w = crop_factors
    img_w, img_h = image.size
    if target_h > img_h or target_w > img_w:
        raise ValueError("Crop size exceeds image dimensions")
    x = rng.randint(0, img_w - target_w)
    y = rng.randint(0, img_h - target_h)
    return image.crop((x, y, x + target_w, y + target_h)), [[x, y], [x + target_w, y + target_h]]


def motion_blur(image: Image.Image, kernel_size: int = 15, angle: float = 0) -> Image.Image:
    """transforms.py:144-161 (cv2 rotated line kernel)."""
    if cv2 is None:
        raise RuntimeError("cv2 unavailable")
    kernel = np.zeros((kernel_size, kernel_size), dtype=np.float32)
    kernel[kernel_size // 2, :] = 1.0
    center = (kernel_size / 2 - 0.5, kernel_size / 2 - 0.5)
    M = cv2.getRotationMatrix2D(center, angle, 1)
    rotated = cv2.warpAffine(kernel, M, (kernel_size, kernel_size))
    s = rotated.sum()
    rotated /= s if s != 0 else 1

    img = np.array(image)
    if img.ndim == 2:
        blurred = cv2.filter2D(img, -1, rotated, borderType=cv2.BORDER_REFLECT)
    else:
        blurred = np.zeros_like(img)
        for c in range(img.shape[2]):
            blurred[..., c] = cv2.filter2D(img[..., c], -1, rotated, borderType=cv2.BORDER_REFLECT)
    return Image.fromarray(blurred.astype(np.uint8))


def _split_patches(image: Image.Image, h_splits: int, w_splits: int):
    img_w, img_h = image.size
    hs = [img_h // h_splits] * (h_splits - 1)
    hs.append(img_h - sum(hs))
    ws = [img_w // w_splits] * (w_splits - 1)
    ws.append(img_w - sum(ws))
    patches = []
    y = 0
    for ph in hs:
        x = 0
        for pw in ws:
            patches.append(image.crop((x, y, x + pw, y + ph)))
            x += pw
        y += ph
    return patches, hs, ws


def shuffle_patch(
    image: Image.Image,
    num_splits: Tuple[int, int],
    gap_size: int = 2,
    rng: Optional[_random.Random] = None,
) -> Image.Image:
    """transforms.py:164-208: split, shuffle, reassemble with white gaps."""
    rng = rng or _random
    h_splits, w_splits = num_splits
    patches, hs, ws = _split_patches(image, h_splits, w_splits)
    rng.shuffle(patches)
    total_w = sum(ws) + (w_splits - 1) * gap_size
    total_h = sum(hs) + (h_splits - 1) * gap_size
    out = Image.new(image.mode, (total_w, total_h), color=(255, 255, 255))
    y = 0
    idx = 0
    for ph in hs:
        x = 0
        for pw in ws:
            out.paste(patches[idx], (x, y))
            x += pw + gap_size
            idx += 1
        y += ph + gap_size
    return out


def inpainting(
    image: Image.Image,
    num_splits: Tuple[int, int],
    blank_ratio: float = 0.3,
    blank_color: Tuple[int, int, int] = (255, 255, 255),
    rng: Optional[_random.Random] = None,
) -> Image.Image:
    """transforms.py:211-263: blank out a random subset of patches."""
    rng = rng or _random
    h_splits, w_splits = num_splits
    patches, hs, ws = _split_patches(image, h_splits, w_splits)
    total = h_splits * w_splits
    num_blank = max(0, min(int(total * blank_ratio), total))
    blank_indices = set(rng.sample(range(total), num_blank))
    out = Image.new("RGB", image.size)
    y = 0
    idx = 0
    for ph in hs:
        x = 0
        for pw in ws:
            patch = (
                Image.new("RGB", patches[idx].size, color=blank_color)
                if idx in blank_indices
                else patches[idx]
            )
            out.paste(patch, (x, y))
            x += pw
            idx += 1
        y += ph
    return out
