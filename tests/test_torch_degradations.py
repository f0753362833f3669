"""The port's copy of the training-time image degradations
(unimedvl_tpu_torch/data/degradations.py) against the JAX package's module:
each transform gives the same pixels under the same ``random.Random`` seed
(exact: both are the same PIL and cv2 calls)."""

import random

import numpy as np
import pytest
from PIL import Image

from unimedvl_tpu.data import degradations as jdeg
from unimedvl_tpu_torch.data import degradations as deg


def _image(mode="RGB", size=(45, 37)):
    rng = np.random.default_rng(0)
    shape = (size[1], size[0]) + ((3,) if mode == "RGB" else ())
    return Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)


CASES = [  # name, call, the image modes the transform takes
    ("decolorization", lambda m, im, r: m.decolorization(im), ("RGB",)),
    ("downscale", lambda m, im, r: m.downscale(im, 0.37), ("RGB", "L")),
    ("crop", lambda m, im, r: m.crop(im, (20, 17), rng=r), ("RGB", "L")),
    ("motion_blur", lambda m, im, r: m.motion_blur(im, kernel_size=9, angle=30), ("RGB", "L")),
    ("shuffle_patch", lambda m, im, r: m.shuffle_patch(im, (3, 4), gap_size=2, rng=r), ("RGB",)),
    ("inpainting", lambda m, im, r: m.inpainting(im, (4, 3), blank_ratio=0.4, rng=r), ("RGB",)),
]
PARAMS = [(name, call, mode) for name, call, modes in CASES for mode in modes]


@pytest.mark.parametrize("name,call,mode", PARAMS, ids=[f"{p[0]}-{p[2]}" for p in PARAMS])
def test_pixel_equal_to_the_jax_module(name, call, mode):
    im = _image(mode)
    got = call(deg, im, random.Random(7))
    want = call(jdeg, im, random.Random(7))
    if name == "crop":
        (got, gbox), (want, wbox) = got, want
        assert gbox == wbox
    assert got.mode == want.mode and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
