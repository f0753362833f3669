"""The port's own config tree, image preprocessing and special-token
registration against the JAX package's: the port imports nothing of
``unimedvl_tpu``, so it keeps copies, and these tests hold the copies to the
originals: the same fields and defaults, the same outputs on seeded inputs
(exactly: both are numpy and PIL code).

``port_config`` is how every port test turns a JAX-package config into the
port's: through ``dataclasses.asdict`` and ``from_dict``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from unimedvl_tpu import config as jconfig
from unimedvl_tpu.data import imaging as jimaging
from unimedvl_tpu.data import tokenizer as jtokenizer
from unimedvl_tpu_torch import config as tconfig
from unimedvl_tpu_torch.data import imaging, tokenizer

CLASSES = ["LLMConfig", "ViTConfig", "VAEConfig", "E2EVAEConfig", "BagelConfig",
           "GenerationConfig", "TransformConfig"]


# The port's tests run their torch ops on one thread per process. They run in several
# pytest-xdist workers at once, beside spawned ranks and XLA's own threads, and their
# tensors are small: the workers' intra-op threads (one per core each) only spun against
# one another, and every module imports this one when it is collected.
torch.set_num_threads(1)


def port_config(cfg):
    """The port's config object for a JAX-package config object."""
    return getattr(tconfig, type(cfg).__name__).from_dict(dataclasses.asdict(cfg))


_INIT_PARAMS = {}


def init_params(seed: int, cfg, llm2vae_zero: bool = True):
    """``unimedvl_tpu.models.bagel.init_params(PRNGKey(seed), cfg,
    llm2vae_zero)``, drawn once per test run: the draw compiles its random
    ops anew in every test module (tests/conftest.py clears jax's caches
    between modules), 20–50 s a draw on a loaded host; modules that ask for
    the same weights share the arrays (immutable) in containers of their
    own, within a process and, under pytest-xdist, across the run's workers
    (:func:`_run_shared_draw`)."""
    import jax

    key = (seed, cfg, llm2vae_zero)
    if key not in _INIT_PARAMS:
        _INIT_PARAMS[key] = _run_shared_draw(key)
    return jax.tree.map(lambda x: x, _INIT_PARAMS[key])


def _draw(key):
    import jax

    from unimedvl_tpu.models import bagel as jbagel

    seed, cfg, llm2vae_zero = key
    return jbagel.init_params(jax.random.PRNGKey(seed), cfg, llm2vae_zero=llm2vae_zero)


def _run_shared_draw(key):
    """The draw of ``key``, made by the first worker of this pytest-xdist run
    that asks for it (``PYTEST_XDIST_TESTRUNUID`` names the run) and stored
    as numpy arrays in a file of the run's own under the temporary
    directory; the other workers wait on its lock and load the same arrays,
    bit for bit. Without xdist the draw is made here."""
    import fcntl
    import hashlib
    import os
    import pickle
    import shutil
    import tempfile
    import time
    from pathlib import Path

    import jax
    import jax.numpy as jnp

    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return _draw(key)
    folder = Path(tempfile.gettempdir()) / f"unimedvl_torch_draws_{run}"
    if not folder.exists():  # the folders of earlier runs (a day old) go
        for old in folder.parent.glob("unimedvl_torch_draws_*"):
            try:  # another worker of this run may be removing it too
                if time.time() - old.stat().st_mtime > 86400:
                    shutil.rmtree(old, ignore_errors=True)
            except FileNotFoundError:
                pass
    folder.mkdir(exist_ok=True)
    name = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
    path = folder / f"{name}.pkl"
    with open(folder / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return jax.tree.map(jnp.asarray, pickle.load(f))
        tree = _draw(key)
        partial = path.with_suffix(".partial")
        with open(partial, "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, tree), f)
        os.replace(partial, path)
        return tree


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        if dataclasses.is_dataclass(default):
            default = dataclasses.asdict(default)
        out[f.name] = (str(f.type), default)
    return out


class TestConfig:
    @pytest.mark.parametrize("name", CLASSES)
    def test_same_fields_and_defaults(self, name):
        assert _fields(getattr(tconfig, name)) == _fields(getattr(jconfig, name))
        assert dataclasses.asdict(getattr(tconfig, name)()) == dataclasses.asdict(
            getattr(jconfig, name)())

    @pytest.mark.parametrize("name", CLASSES)
    def test_round_trip_through_a_dict(self, name):
        cfg = getattr(jconfig, name)()
        port = port_config(cfg)
        assert type(port) is getattr(tconfig, name)
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
        assert port == getattr(tconfig, name)()

    def test_nested_and_none(self):
        cfg = jconfig.BagelConfig(
            llm=jconfig.LLMConfig(hidden_size=64, num_attention_heads=4, head_dim_override=32),
            vit=None, vae=jconfig.VAEConfig(ch_mult=(1, 2), downsample=2), visual_und=False,
            e2e=jconfig.E2EVAEConfig(bn_eps=1e-3))
        port = port_config(cfg)
        assert isinstance(port.llm, tconfig.LLMConfig) and port.vit is None
        assert port.vae.ch_mult == (1, 2) and isinstance(port.e2e, tconfig.E2EVAEConfig)
        for prop in ("latent_downsample", "latent_channel", "patch_latent_dim"):
            assert getattr(port, prop) == getattr(cfg, prop)
        for prop in ("head_dim", "use_moe", "mot_attention"):
            assert getattr(port.llm, prop) == getattr(cfg.llm, prop)

    def test_unknown_field_raises(self):
        with pytest.raises(TypeError, match="no field"):
            tconfig.LLMConfig.from_dict({"hidden_size": 8, "n_layers": 2})

    def test_vae_downsample_check_is_kept(self):
        with pytest.raises(ValueError, match="inconsistent"):
            tconfig.VAEConfig(downsample=4)

    def test_transform_presets(self):
        for preset in ("vit_vqa", "vit_interactive", "vae_interactive"):
            assert dataclasses.asdict(getattr(tconfig.TransformConfig, preset)()) == \
                dataclasses.asdict(getattr(jconfig.TransformConfig, preset)())


class TestImaging:
    @pytest.mark.parametrize("seed", range(4))
    def test_compute_resize_shape(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(50):
            w, h = (int(v) for v in rng.integers(20, 3000, 2))
            args = (w, h, 980, 378, 14, 2_007_040, int(rng.integers(1, 4)))
            assert imaging.compute_resize_shape(*args) == jimaging.compute_resize_shape(*args)

    @pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
    def test_image_transform(self, mode):
        rng = np.random.default_rng(5)
        chans = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
        arr = rng.integers(0, 256, (70, 50, chans), dtype=np.uint8)
        img = Image.fromarray(arr[..., 0] if chans == 1 else arr, mode)
        args = (64, 16, 8, 4096)
        got = imaging.ImageTransform(*args)(imaging.pil_img2rgb(img))
        want = jimaging.ImageTransform(*args)(jimaging.pil_img2rgb(img))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    def test_patchify_and_position_ids(self):
        x = np.random.default_rng(6).standard_normal((3, 28, 42)).astype(np.float32)
        np.testing.assert_array_equal(imaging.patchify(x, 14), jimaging.patchify(x, 14))
        for fn in ("position_ids_extrapolate", "position_ids_interpolate"):
            np.testing.assert_array_equal(
                getattr(imaging, fn)(56, 98, 14, 70), getattr(jimaging, fn)(56, 98, 14, 70))
        lat = np.random.default_rng(7).standard_normal((6, 16)).astype(np.float32)
        np.testing.assert_array_equal(imaging.unpatchify_latent(lat, 2, 3, 2, 4),
                                      jimaging.unpatchify_latent(lat, 2, 3, 2, 4))


class _Tokenizer:
    def __init__(self, known):
        self.ids = {t: i for i, t in enumerate(known)}
        self.special_tokens_map = {"eos_token": "<|im_end|>",
                                   "additional_special_tokens": ["<|vision_start|>"]}

    def add_tokens(self, tokens):
        for t in tokens:
            self.ids.setdefault(t, 1000 + len(self.ids))
        return len(tokens)

    def convert_tokens_to_ids(self, tok):
        return self.ids[tok]


def test_add_special_tokens():
    known = ["<|im_end|>", "<|vision_start|>"]
    got_tok, got_ids, got_new = tokenizer.add_special_tokens(_Tokenizer(known))
    want_tok, want_ids, want_new = jtokenizer.add_special_tokens(_Tokenizer(known))
    assert got_ids == want_ids and got_new == want_new == 2
    assert got_tok.ids == want_tok.ids
    assert tokenizer.SPECIAL_TOKENS == jtokenizer.SPECIAL_TOKENS
