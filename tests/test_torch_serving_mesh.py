"""``ContinuousBatcher(mesh=...)`` and ``run_vqa_eval(mesh=...)`` of the port
on spawned gloo ranks against the JAX package's mesh engine (the counterpart
of tests/test_serving_mesh.py): a mixed image / text batch with an
over-capacity rejection, the speculative engine, the prefix cache and the
batched eval, on a (2, 4) mesh (slots over data = 2, heads over model = 4,
kv heads replicated over pairs). TINY, fp32, ``llm2vae_zero=False``. One
spawn of the mesh runs every case (a module fixture). Answers, ``errors``
keys and ``stats["emitted_tokens"]`` must equal the JAX engine's, on every
rank.
"""

import jax
import numpy as np
import pytest
from PIL import Image

from unimedvl_tpu.data.imaging import ImageTransform
from unimedvl_tpu.data.tokenizer import add_special_tokens
from unimedvl_tpu.eval import vqa as jvqa
from unimedvl_tpu.inference.serving import ContinuousBatcher, Request
from unimedvl_tpu.parallel import create_mesh
from unimedvl_tpu_torch.parallel import mesh as pmesh
from unimedvl_tpu_torch.tools import dryrun_mesh
from unimedvl_tpu_torch.weights.loader import from_jax_params

from tests.test_pipeline import TINY, FakeTokenizer
from tests.test_torch_config import init_params, port_config

RANKS_TIMEOUT_S = 240.0
BATCH = dict(num_slots=4, capacity=512, chunk=4)
PREAMBLE = "shared preamble: "


def _image(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (24, 28, 3), dtype=np.uint8)


REQUESTS = [
    ("alpha", None, 6), ("what is shown?", _image(1), 5), ("beta question", None, 6),
    ("describe", _image(2), 5), ("gamma?", None, 4),
    ("over capacity " * 40, None, 120),  # rejected before prefill
]
PREFIXED = [("alpha", None, 6), ("beta question", None, 5), ("gamma?", None, 4)]
SAMPLES = [
    {"image": _image(3), "question": "color?", "answer": "red"},
    {"image": None, "question": "ok?", "answer": "yes"},
    {"image": _image(4), "question": "what organ?", "answer": "lung"},
]


@pytest.fixture(scope="module")
def params():
    return init_params(0, TINY, llm2vae_zero=False)


def _jax_serve(params, requests, mesh=None, prefix=None, **kw):
    tok, ids, _ = add_special_tokens(FakeTokenizer())
    b = ContinuousBatcher(params, TINY, tok, ids, vit_transform=ImageTransform(32, 8, 2, 1024),
                          mesh=mesh, **BATCH, **kw)
    pid = b.register_prefix(prefix) if prefix else None
    rids = [b.submit(Request(prompt=p, image=None if i is None else Image.fromarray(i),
                             max_new_tokens=m, prefix_id=pid)) for p, i, m in requests]
    done = b.run()
    return rids, done, sorted(b.errors), int(b.stats["emitted_tokens"])


@pytest.fixture(scope="module")
def jax_side(params):
    mesh = create_mesh((2, 4))
    out = {"mixed": _jax_serve(params, REQUESTS, mesh),
           "mixed_single": _jax_serve(params, REQUESTS),
           "spec": _jax_serve(params, REQUESTS, mesh, spec_decode=True, spec_k=3),
           "prefix": _jax_serve(params, PREFIXED, mesh, prefix=PREAMBLE)}
    tok, ids, _ = add_special_tokens(FakeTokenizer())
    samples = [dict(s, image=None if s["image"] is None else Image.fromarray(s["image"]))
               for s in SAMPLES]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvqa, "build_transform", lambda: ImageTransform(32, 8, 2, 1024))
        out["vqa"] = jvqa.run_vqa_eval(params, TINY, tok, ids, samples, max_new_tokens=5,
                                       num_slots=4, capacity=512, mesh=mesh)
    return out


@pytest.fixture(scope="module")
def ranks(params):
    model = from_jax_params(jax.tree.map(np.asarray, params), port_config(TINY), device="cpu")
    cases = [
        dict(kind="serve", batch_kw=BATCH, requests=REQUESTS),
        dict(kind="serve", batch_kw=dict(BATCH, spec_decode=True, spec_k=3), requests=REQUESTS),
        dict(kind="serve", batch_kw=BATCH, requests=PREFIXED, prefix=PREAMBLE),
        dict(kind="vqa", samples=SAMPLES, kw=dict(max_new_tokens=5, num_slots=4,
                                                   capacity=512)),
        # 3 slots do not split over data = 2: the pool is whole on every data rank
        dict(kind="serve", batch_kw=dict(BATCH, num_slots=3), requests=REQUESTS),
        UNIFIED,
    ]
    # the mixed batch, the speculative engine and unified serving again by the device
    # programs' plain route (chunks, spec chunks, admission blocks, flow steps)
    cases += [dict(c, batch_kw=dict(c["batch_kw"], graphs=True))
              for c in (cases[0], cases[1], UNIFIED)]
    return pmesh.run_on_ranks(dryrun_mesh.run_mesh_cases, 8, ("data", "model"), (2, 4), model,
                              cases, timeout_s=RANKS_TIMEOUT_S)


# unified serving: two text requests beside two text-to-image requests of one geometry
# (one grouped job over "data"), through an inferencer of the same mesh
UNIFIED = dict(kind="serve", batch_kw=dict(BATCH, gen_chunk=2, gen_group=2),
               requests=REQUESTS[:2],
               t2i=[("a chest x-ray", (16, 16), dict(num_timesteps=3, cfg_interval=(0.0, 1.0))),
                    ("a knee", (16, 16), dict(num_timesteps=3, cfg_interval=(0.0, 1.0)))])


def _every_rank(per_rank, i):
    for r in per_rank[1:]:
        assert r[i] == per_rank[0][i]
    return per_rank[0][i]


class TestServingMesh:
    def test_mixed_batch_tp_dp_mesh(self, jax_side, ranks):
        """Slots over data = 2 x TP 4: the JAX mesh engine's answers, the
        over-capacity rejection and the emitted-token count, on every rank."""
        got = _every_rank(ranks, 0)
        assert got == jax_side["mixed"]
        assert jax_side["mixed"][1:] == jax_side["mixed_single"][1:]
        assert len(got[2]) == 1

    def test_spec_engine_tp_dp_mesh(self, jax_side, ranks):
        got = _every_rank(ranks, 1)
        assert got[:3] == jax_side["spec"][:3]
        assert got[1] == jax_side["mixed"][1]  # greedy-exact

    def test_prefix_cache_on_mesh(self, jax_side, ranks):
        got = _every_rank(ranks, 2)
        assert got == jax_side["prefix"] and not got[2]

    def test_vqa_eval_mesh(self, jax_side, ranks):
        assert _every_rank(ranks, 3) == jax_side["vqa"]

    def test_pool_replicated_when_slots_do_not_split(self, jax_side, ranks):
        got = _every_rank(ranks, 4)
        assert got[1] == jax_side["mixed"][1] and got[2] == jax_side["mixed"][2]

    def test_unified_serving_on_mesh(self, ranks, params):
        """``pipeline=``: text answers equal to the same engine's without the
        mesh (the port's, held to JAX's in tests/test_torch_gen_serving.py),
        images within 1 per pixel (fp32 sums over ranks in another order)."""
        got = ranks[0][5]
        model = from_jax_params(jax.tree.map(np.asarray, params), port_config(TINY),
                                device="cpu")
        want = dryrun_mesh.run_case(model, None, UNIFIED)
        assert got[0] == want[0] and got[2] == want[2] == [] and got[3] == want[3]
        for rid in want[0]:
            a, b = got[1][rid], want[1][rid]
            if isinstance(b, str):
                assert a == b, rid
            else:
                assert a.shape == b.shape == (16, 16, 3)
                np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), atol=1.0)
        for r in ranks[1:]:  # every rank holds the same results
            for rid in want[0]:
                np.testing.assert_array_equal(np.asarray(r[5][1][rid]), np.asarray(got[1][rid]))

    @pytest.mark.parametrize("name,i,eager", [("mixed", 6, 0), ("spec", 7, 1)])
    def test_batcher_programs_tp_dp_mesh(self, jax_side, ranks, name, i, eager):
        """``graphs=True`` on the gloo ranks: the chunk, spec-chunk and
        admission programs' plain route gives the eager engine's answers,
        errors and emitted tokens, and so the JAX mesh engine's."""
        got = _every_rank(ranks, i)
        assert got == _every_rank(ranks, eager)
        assert got[:3] == jax_side[name][:3]

    def test_unified_programs_on_mesh(self, ranks):
        """Unified serving by the programs' plain route (the grouped flow
        program gathers its streams over "data"): texts and images equal to
        the eager route's, bit for bit, on every rank."""
        for r in ranks:
            got, want = r[8], r[5]
            assert got[0] == want[0] and got[2:] == want[2:]
            for rid in want[0]:
                np.testing.assert_array_equal(np.asarray(got[1][rid]), np.asarray(want[1][rid]))

    def test_refusals(self):
        """The pool ladder with a mesh raises, as the JAX batcher asserts; a
        mesh without the serving axes raises."""
        from unimedvl_tpu_torch.inference.serving import ContinuousBatcher as PortBatcher

        model = dryrun_mesh.tiny_model()
        tok, ids = dryrun_mesh.tokenizer()
        one = pmesh.make_mesh(("data", "model"), (1, 1))
        with pytest.raises(ValueError, match="pool_ladder"):
            PortBatcher(model, tok, ids, mesh=one, pool_ladder=True)
        with pytest.raises(ValueError, match="'data', 'model'"):
            PortBatcher(model, tok, ids, mesh=pmesh.make_mesh(("model", "seq"), (1, 1)))
