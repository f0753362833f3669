"""Unified generation serving (M10b) of the PyTorch port against the JAX
package, on the CPU: tests/test_pipeline.py's TINY config with its VAE and a
random velocity head (``llm2vae_zero=False``), the same weights
(``from_jax_params``), fp32, five timesteps.

- ``bagel.generate_latents_group`` against the JAX function on the same
  caches and noise, with and without CFG, and over a ``step_range`` split:
  atol 1e-5 (seen: 1.1e-6 with CFG, 4.8e-7 without, on latents of |x| up to
  4.4). Each image of a group against its own one-image loop: atol 1e-6
  (seen: equal with CFG, 2.4e-7 without: CPU GEMMs over another row count
  block their sums otherwise).
- The generation jobs (``start_gen_job``, ``advance_gen_job``,
  ``merge_gen_jobs``, ``finish_gen_job(_group)``) against the JAX jobs, the
  port's noise replaying the JAX inferencer's draws (a copy of its key, split
  in the same order): latents within 1e-4, images within 1 per uint8 pixel,
  as tests/test_torch_pipeline.py's ``TestGeneration``; a chunked job equals
  the port's one-shot ``gen_image`` exactly.
- The batcher's text-to-image side (tests/test_serving.py:317-520): a
  unified run's text ids equal the JAX unified batcher's token for token and
  its image the one-shot recipe's exactly; the grouped engine against the
  sequential one; incompatible sizes; cancelling one member; no pipeline.

Time budget: about 60 s alone, most of it the JAX side's compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from unimedvl_tpu.data.imaging import ImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu.inference import InterleaveInferencer as JaxInferencer
from unimedvl_tpu.inference import serving as jserving
from unimedvl_tpu.models import bagel as jbagel
from unimedvl_tpu_torch.data import imaging as timaging
from unimedvl_tpu_torch.data import tokenizer as ttokenizer
from unimedvl_tpu_torch.inference import ContinuousBatcher, InterleaveInferencer, Request
from unimedvl_tpu_torch.models import bagel
from unimedvl_tpu_torch.ops import flash_attention as fa
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY as CFG
from tests.test_torch_config import init_params, port_config
from tests.test_torch_pipeline import FakeTokenizer
from tests.test_torch_serving import _to_torch

KNOBS = dict(cfg_text_scale=2.0, cfg_img_scale=1.5, num_timesteps=5)
T2I = dict(image_size=(32, 32), gen_params=dict(num_timesteps=5))
ENGINE = dict(num_slots=2, capacity=128, chunk=4)


@pytest.fixture(scope="module")
def setup():
    params = init_params(0, CFG, llm2vae_zero=False)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(CFG), device="cpu")
    tok, ids, _ = add_special_tokens(FakeTokenizer())
    ttok, tids, _ = ttokenizer.add_special_tokens(FakeTokenizer())
    return dict(params=params, model=model, tok=tok, ids=ids, ttok=ttok, tids=tids)


def jax_pipe(s, seed=7):
    return JaxInferencer(s["params"], CFG, s["tok"], s["ids"],
                         vae_transform=ImageTransform(32, 8, 8, 1024),
                         vit_transform=ImageTransform(32, 8, 2, 1024), seed=seed)


def port_pipe(s, seed=7):
    """The port's inferencer, its draws replaying those of a JAX inferencer
    of the same seed."""
    inf = InterleaveInferencer(s["model"], s["ttok"], s["tids"],
                               vae_transform=timaging.ImageTransform(32, 8, 8, 1024),
                               vit_transform=timaging.ImageTransform(32, 8, 2, 1024), seed=seed)
    key = [jax.random.PRNGKey(seed)]

    def randn(shape):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))

    inf._randn = randn
    return inf


def t2i_contexts(pipe, prompt):
    """The batcher's context recipe: cfg_text before the prompt, cfg_img with it."""
    g = pipe.init_gen_context()
    ci, ct = g.fork(), g.fork()
    return pipe.update_context_text(prompt, g), ct, pipe.update_context_text(prompt, ci)


def job(pipe, prompt, size=(32, 32), **kw):
    g, ct, ci = t2i_contexts(pipe, prompt)
    return pipe.start_gen_job(size, g, cfg_text_precontext=ct, cfg_img_precontext=ci,
                              **{**KNOBS, **kw})


def run_job(pipe, j, steps=2):
    while not j.done:
        j = pipe.advance_gen_job(j, steps)
    return j


def assert_images_close(got, want):
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


# ---------------------------------------------------------------------------
# generate_latents_group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group_inputs(setup):
    """Two images' stacked [main, cfg_text, cfg_img] context caches (JAX),
    g-major, their positions, latent position ids and noise [2, 16, 16]."""
    pipe = jax_pipe(setup)
    jobs = [job(pipe, p) for p in ("a chest x-ray", "a brain mri scan")]
    merged = pipe.merge_gen_jobs(jobs)
    noise = np.random.default_rng(0).standard_normal((2, 16, CFG.patch_latent_dim))
    return merged, noise.astype(np.float32), pipe._start_end()


@pytest.mark.parametrize("cfg_on", [True, False], ids=["cfg", "no-cfg"])
def test_generate_latents_group_matches_jax(setup, group_inputs, cfg_on):
    """Two images in one forward a step; steps 0-2 inside the CFG interval,
    3 outside (each image's main stream alone). Without CFG the caches hold
    one stream per image. Then the same loop split at step 2."""
    merged, noise, se = group_inputs
    caches, positions = merged.caches, merged.positions
    kw = dict(num_timesteps=5, cfg_text_scale=2.0, cfg_img_scale=1.5, cfg_interval=(0.4, 1.0),
              use_text_cfg=cfg_on, use_img_cfg=cfg_on)
    if not cfg_on:
        caches = caches.replace(k=caches.k[:, 0::3], v=caches.v[:, 0::3],
                                lens=caches.lens[0::3])
        positions = positions[0::3]
    want = np.asarray(jbagel.generate_latents_group(
        setup["params"], CFG, caches, positions, merged.pos_ids, jnp.asarray(noise), se, **kw))
    args = (setup["model"], _to_torch(caches), torch.from_numpy(np.array(positions)),
            torch.from_numpy(np.array(merged.pos_ids)), torch.from_numpy(noise),
            torch.from_numpy(np.array(se)))
    got = bagel.generate_latents_group(*args, **kw)
    assert got.shape == (2, 16, CFG.patch_latent_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    half = bagel.generate_latents_group(*args, **kw, step_range=(0, 2))
    split = bagel.generate_latents_group(*args[:4], half, args[5], **kw, step_range=(2, 4))
    torch.testing.assert_close(split, got, rtol=0, atol=0)
    # each image alone through the one-image loop (GEMMs over fewer rows)
    S1 = 3 if cfg_on else 1
    for g in range(2):
        c = args[1]._map(lambda t: t[:, g * S1:(g + 1) * S1], lambda t: t, args[1].lens[
            g * S1:(g + 1) * S1])
        one = bagel.generate_latents(setup["model"], c, args[2][g * S1:(g + 1) * S1], args[3],
                                     args[4][g], args[5], **kw)
        np.testing.assert_allclose(one.numpy(), got[g].numpy(), rtol=0, atol=1e-6)


def test_group_renorm_reduces_per_image(setup, group_inputs):
    """The global renorm of one image does not see the other: doubling image
    1's noise leaves image 0's latents as they were."""
    merged, noise, se = group_inputs
    args = [setup["model"], _to_torch(merged.caches), torch.from_numpy(np.array(merged.positions)),
            torch.from_numpy(np.array(merged.pos_ids)), torch.from_numpy(noise),
            torch.from_numpy(np.array(se))]
    kw = dict(num_timesteps=5, cfg_text_scale=4.0, cfg_img_scale=1.5, cfg_interval=(0.0, 1.0),
              use_text_cfg=True, use_img_cfg=True)
    base = bagel.generate_latents_group(*args, **kw)
    args[4] = args[4] * torch.tensor([1.0, 2.0])[:, None, None]
    moved = bagel.generate_latents_group(*args, **kw)
    torch.testing.assert_close(moved[0], base[0], rtol=0, atol=1e-6)
    assert (moved[1] - base[1]).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# the generation jobs
# ---------------------------------------------------------------------------

class TestGenJobs:
    def test_chunked_job_equals_one_shot(self, setup):
        """start/advance/finish in 2-step segments give exactly the one-shot
        ``gen_image`` (tests/test_serving.py:330)."""
        pipe = port_pipe(setup)
        g, ct, ci = t2i_contexts(pipe, "a scan")
        want = pipe.gen_image((32, 32), g, cfg_text_precontext=ct, cfg_img_precontext=ci,
                              **KNOBS)
        pipe = port_pipe(setup)
        j, segments = job(pipe, "a scan"), 0
        while not j.done:
            j = pipe.advance_gen_job(j, 2)
            segments += 1
        assert segments == 2  # 4 flow steps in 2-step segments
        np.testing.assert_array_equal(np.asarray(pipe.finish_gen_job(j)), np.asarray(want))

    def test_job_matches_jax(self, setup):
        jpipe, tpipe = jax_pipe(setup), port_pipe(setup)
        want = run_job(jpipe, job(jpipe, "a scan"))
        got = run_job(tpipe, job(tpipe, "a scan"))
        assert (got.step, got.total_steps) == (want.step, want.total_steps) == (4, 4)
        assert torch.equal(got.caches.lens, torch.from_numpy(np.array(want.caches.lens)))
        np.testing.assert_allclose(got.x_t.numpy(), np.asarray(want.x_t), rtol=1e-4, atol=1e-4)
        assert_images_close(tpipe.finish_gen_job(got), jpipe.finish_gen_job(want))

    def test_merged_jobs_match_jax(self, setup):
        """Two jobs drawn in order, merged (caches g-major), advanced in one
        forward a step and finished as a group."""
        prompts = ("a chest x-ray", "a brain mri scan")
        jpipe, tpipe = jax_pipe(setup), port_pipe(setup)
        want = run_job(jpipe, jpipe.merge_gen_jobs([job(jpipe, p) for p in prompts]))
        parts = [job(tpipe, p) for p in prompts]
        got = tpipe.merge_gen_jobs(parts)
        assert got.x_t.shape == (2, 16, CFG.patch_latent_dim) and got.caches.k.shape[1] == 6
        assert torch.equal(got.caches.k[:, 3:], parts[1].caches.k)
        got = run_job(tpipe, got)
        np.testing.assert_allclose(got.x_t.numpy(), np.asarray(want.x_t), rtol=1e-4, atol=1e-4)
        images = tpipe.finish_gen_job_group(got)
        for g, w in zip(images, jpipe.finish_gen_job_group(want)):
            assert_images_close(g, w)
        with pytest.raises(ValueError, match="grouped"):
            tpipe.finish_gen_job(got)

    def test_incompatible_jobs_do_not_merge(self, setup):
        tpipe = port_pipe(setup)
        with pytest.raises(ValueError, match="differ"):
            tpipe.merge_gen_jobs([job(tpipe, "a"), job(tpipe, "b", size=(64, 32))])


# ---------------------------------------------------------------------------
# the batcher's text-to-image side
# ---------------------------------------------------------------------------

def port_engine(s, pipeline=None, **kw):
    return ContinuousBatcher(s["model"], s["ttok"], s["tids"],
                             vit_transform=timaging.ImageTransform(32, 8, 2, 1024),
                             pipeline=pipeline, **{**ENGINE, **kw})


def run_engine(eng, requests, request=Request):
    """(results in submission order, rid -> ids of each text answer)."""
    ids = {}

    def record(slot, finish=eng._finish):
        ids[slot.request_id] = list(slot.out_ids)
        finish(slot)

    eng._finish = record
    rids = [eng.submit(request(**r)) for r in requests]
    out = eng.run()
    return [out.get(r) for r in rids], [ids.get(r) for r in rids]


class TestBatcher:
    def test_unified_serving_text_and_t2i(self, setup):
        """Text and an image in one engine (tests/test_serving.py:353): the
        text ids equal the JAX unified batcher's token for token, the image
        equals the one-shot recipe's exactly and the JAX batcher's within 1
        per pixel."""
        requests = [dict(prompt=p, max_new_tokens=5) for p in ("alpha", "beta")] + [
            dict(prompt="a chest x-ray", **T2I)]
        jeng = jserving.ContinuousBatcher(
            setup["params"], CFG, setup["tok"], setup["ids"],
            vit_transform=ImageTransform(32, 8, 2, 1024), pipeline=jax_pipe(setup, 3),
            gen_chunk=2, **ENGINE)
        want, want_ids = run_engine(jeng, requests, jserving.Request)
        eng = port_engine(setup, port_pipe(setup, 3), gen_chunk=2)
        got, got_ids = run_engine(eng, requests)
        assert not eng.errors and not jeng.errors
        assert got_ids[:2] == want_ids[:2] and got[:2] == want[:2]
        one_shot = port_pipe(setup, 3).interleave_inference(
            ["a chest x-ray"], num_timesteps=5, image_shapes=(32, 32))[-1]
        assert isinstance(got[2], Image.Image)
        np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(one_shot))
        assert_images_close(got[2], want[2])
        assert eng.stats["gen_images"] == 1 and eng.stats["gen_s"] > 0
        assert eng.stats["emitted_tokens"] == jeng.stats["emitted_tokens"]

    def test_grouped_matches_sequential(self, setup):
        """gen_group 2 denoises both images in one forward a step
        (tests/test_serving.py:440): the images equal the sequential
        engine's exactly, in fewer rounds; the group's K1b-route calls run
        at twice the streams."""
        requests = [dict(prompt=p, **T2I) for p in ("a chest x-ray", "a brain mri")]
        results = {}
        for group in (1, 2):
            eng = port_engine(setup, port_pipe(setup, 3), gen_chunk=2, gen_group=group)
            before = fa.q_preproc_counts["plain"]
            results[group] = run_engine(eng, requests)[0], eng
            assert not eng.errors and eng.stats["gen_images"] == 2
            results[group] += (fa.q_preproc_counts["plain"] - before,)
        (seq, eng1, calls1), (grp, eng2, calls2) = results[1], results[2]
        for w, g in zip(seq, grp):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert eng2.stats["rounds"] < eng1.stats["rounds"]
        assert calls2 * 2 == calls1  # one denoise forward a step for both images

    def test_incompatible_sizes_split(self, setup):
        eng = port_engine(setup, port_pipe(setup, 3), gen_chunk=2)
        out, _ = run_engine(eng, [dict(prompt="a", **T2I),
                                  dict(prompt="b", image_size=(64, 32),
                                       gen_params=dict(num_timesteps=5))])
        assert not eng.errors
        assert out[0].size == (32, 32) and out[1].size == (32, 64)

    def test_cancel_one_group_member(self, setup):
        """Cancelling one member mid-denoise leaves the other running; the
        cancelled rid lands in ``errors``; the survivor's image equals the
        uncancelled group's."""
        requests = [dict(prompt=p, **T2I) for p in ("a", "b")]
        full = run_engine(port_engine(setup, port_pipe(setup, 3), gen_chunk=1, gen_group=2),
                          requests)[0]
        eng = port_engine(setup, port_pipe(setup, 3), gen_chunk=1, gen_group=2)
        r1, r2 = (eng.submit(Request(**r)) for r in requests)
        eng._reset_stats()
        eng._round(eng.stats, eng.new_token_ids["eos_token_id"])  # the group and one step
        assert eng._gen_job is not None and eng._gen_job[0] == [r1, r2]
        assert eng.cancel(r2) and eng._gen_job[0] == [r1, None]
        out = eng.run()
        assert r2 not in out and "cancel" in eng.errors[r2]
        np.testing.assert_array_equal(np.asarray(out[r1]), np.asarray(full[0]))
        assert not eng.cancel(r1)  # finished

    def test_cancel_pending_and_ready(self, setup):
        """A pending request is dropped before any device work; a started one
        of another size, waiting for its own group, before its denoise."""
        eng = port_engine(setup, port_pipe(setup, 3), gen_chunk=2, gen_group=2)
        sizes = ((32, 32), (64, 32), (32, 32))
        rids = [eng.submit(Request(prompt=p, image_size=hw, gen_params=dict(num_timesteps=5)))
                for p, hw in zip("abc", sizes)]
        assert eng.cancel(rids[2]) and eng.errors[rids[2]] == "cancelled before start"
        eng._reset_stats()
        eng._round(eng.stats, eng.new_token_ids["eos_token_id"])  # both start, "a" denoises
        assert [r for r, _j in eng._gen_ready] == [rids[1]]
        assert eng.cancel(rids[1]) and eng.errors[rids[1]] == "cancelled before denoise"
        out = eng.run()
        assert list(out) == [rids[0]] and eng.has_work() is False

    def test_t2i_without_pipeline_rejected(self, setup):
        """tests/test_serving.py:507: the image request lands in ``errors``
        before any device work, the text request is answered, as in the JAX
        engine."""
        requests = [dict(prompt="draw", image_size=(32, 32)),
                    dict(prompt="hello", max_new_tokens=4)]
        jeng = jserving.ContinuousBatcher(setup["params"], CFG, setup["tok"], setup["ids"],
                                          vit_transform=ImageTransform(32, 8, 2, 1024), **ENGINE)
        want = run_engine(jeng, requests, jserving.Request)
        eng = port_engine(setup)
        got = run_engine(eng, requests)
        assert got == want and got[0][0] is None
        assert sorted(eng.errors) == sorted(jeng.errors) == [0]
        assert "pipeline" in eng.errors[0]
