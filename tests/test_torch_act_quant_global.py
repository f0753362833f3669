"""K3's second entry (``act_quant.silu_mul_quant_global``) on the CPU: its
launch plan, which the kernels follow on the card, the single call of the
reduction on every shape, and its plain route held to the first entry's and,
through a reduction over shards of one row, to the JAX kernel's on the whole
row (Pallas in interpret mode). No model and no spawned ranks: each case is
a few milliseconds. The card's cases are in ``test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.ops import act_quant as jaq
from unimedvl_tpu_torch.ops import act_quant as aq

SHAPES = [(1, 64), (8, 64), (9, 64), (731, 4736), (4902, 9472), (70000, 64), (3, 24576)]


def _halves(rng, *lead, I):
    """g and u as the strided halves of one fused gate_up output, bf16."""
    gu = torch.from_numpy(rng.standard_normal((*lead, 2 * I), dtype=np.float32) * 2)
    return gu.bfloat16().split(I, dim=-1)


@pytest.mark.parametrize("R,I", SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_plan_depends_on_the_shape_alone_and_covers_every_row_once(R, I, sms):
    """The same (R, I, SM count) gives the same plan; each pass takes every
    row exactly once; each ring CTA's quantize pass takes its rows
    backward, from those its scale pass took last."""
    plan = aq.global_plan(R, I, sms)
    assert plan == aq.global_plan(R, I, sms)
    for quantize in (False, True):
        walks = aq.global_rows(plan, R, quantize)
        assert sorted(r for walk in walks for r in walk) == list(range(R))
    if plan.cluster:
        assert R <= aq.GLOBAL_CLUSTER_MAX_ROWS and plan.ctas == plan.cluster * R
        assert plan.cluster in (2, 4, 8, 16)
    else:
        assert R > aq.GLOBAL_CLUSTER_MAX_ROWS and plan.ctas == min(R, plan.per_sm * sms)
        assert 1 <= plan.stages <= aq.RING_STAGES and plan.per_sm in (1, 2)
        assert plan.stages * 4 * I <= aq.RING_BYTES // plan.per_sm
        scale_walks = aq.global_rows(plan, R, False)
        quant_walks = aq.global_rows(plan, R, True)
        assert [walk[::-1] for walk in scale_walks] == quant_walks
        assert {walk[0] for walk in quant_walks} == set(range(R - plan.ctas, R))


def test_plan_switches_at_the_cluster_limit_and_refuses_wider_rows():
    assert aq.global_plan(aq.GLOBAL_CLUSTER_MAX_ROWS, 9472, 132).cluster > 0
    assert aq.global_plan(aq.GLOBAL_CLUSTER_MAX_ROWS + 1, 9472, 132).cluster == 0
    for I in (aq.KERNEL_MAX_WIDTH + 8, 12, 0):
        with pytest.raises(ValueError, match="KERNEL_MAX_WIDTH"):
            aq.global_plan(4, I, 132)


@pytest.mark.parametrize("lead", [(0,), (5,), (2, 3), (4, 0)])
def test_reduction_runs_once_a_call(lead):
    """Once for no rows, 2-D and 3-D inputs, on the scales it returns."""
    g, u = _halves(np.random.default_rng(0), *lead, I=64)
    calls = []
    before = dict(aq.global_counts)
    q, s = aq.silu_mul_quant_global(g, u, calls.append)
    assert len(calls) == 1 and calls[0] is s
    assert q.shape == (*lead, 64) and q.dtype == torch.int8 and s.shape == (*lead, 1)
    assert aq.global_counts["kernel"] == before["kernel"]


@pytest.mark.parametrize("lead", [(7,), (2, 5)])
def test_without_a_reduction_it_is_the_first_entry(lead):
    g, u = _halves(np.random.default_rng(1), *lead, I=128)
    q, s = aq.silu_mul_quant_global(g, u, None)
    q1, s1 = aq.silu_mul_quant_ref(g, u)
    assert torch.equal(q, q1) and torch.equal(s, s1)


@pytest.mark.parametrize("tp", [2, 4])
def test_shards_reduced_over_ranks_give_the_jax_kernel_on_the_whole_row(tp):
    """tp shards of each row, each through the second entry with a reduction
    that takes the max over the shards' scales: every shard's scales are the
    JAX kernel's on the whole row (1e-6 relative), and its q the matching
    columns of the JAX kernel's q, within one step on at most 1e-3 of them."""
    R, I = 6, 256
    g, u = _halves(np.random.default_rng(2), R, I=I)
    want_q, want_s = (np.asarray(a) for a in jaq.silu_mul_quant(
        jnp.asarray(g.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(u.float().numpy()).astype(jnp.bfloat16), interpret=True))
    w = I // tp
    shards = [(g[:, m * w:(m + 1) * w], u[:, m * w:(m + 1) * w]) for m in range(tp)]
    whole = torch.stack([aq.silu_mul_quant_global(gs, us, None)[1] for gs, us in shards]).amax(0)

    def reduce_max(s):
        s.copy_(torch.maximum(s, whole))

    for m, (gs, us) in enumerate(shards):
        q, s = aq.silu_mul_quant_global(gs, us, reduce_max)
        np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-6, atol=0)
        diff = np.abs(q.numpy().astype(int) - want_q[:, m * w:(m + 1) * w].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _division(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127)


@pytest.mark.parametrize("absmax", [1e-8, 3.3e-5, 0.7, 2.3, 1234.5678, 3.0e7])
def test_fadd_rounding_equals_the_division_at_every_tie(absmax):
    """The quantize pass's rounding (``quant1_fadd``: rint by adding and
    subtracting 1.5 * 2^23, the byte from the sum's bits) against the true
    division at x = (k + 1/2) * scale and one and two ulps either side, for
    every k with |k + 1/2| < 128."""
    k = torch.arange(-128, 128, dtype=torch.float32) + 0.5
    scale = torch.tensor(max(absmax, 1e-8), dtype=torch.float32) / 127.0
    tie = k * scale
    up, down = torch.nextafter(tie, tie + 1), torch.nextafter(tie, tie - 1)
    xs = torch.cat([tie, up, down, torch.nextafter(up, up + 1), torch.nextafter(down, down - 1)])
    assert torch.equal(aq.quantize_fast_twin(xs, scale, fadd=True), _division(xs, scale))


@pytest.mark.parametrize("seed", range(4))
def test_fadd_rounding_equals_the_division_on_any_scale(seed):
    """On values from 1e-30 to 1e30 of either sign against scales from
    1e-10 to 1e10, so that |x / scale| reaches far past the 2^22 where the
    addition stops rounding to integers: the result is clipped either way."""
    rng = np.random.default_rng(seed)
    wide = 10.0 ** rng.uniform(-30, 30, 4096)
    near = np.round(rng.uniform(2.0**21, 2.0**24, 4096) * 4) / 4  # quarters around 2^22-2^23
    x = torch.from_numpy((rng.choice([-1.0, 1.0], 8192) * np.concatenate([wide, near]))
                         .astype(np.float32))
    for scale in (1e-10, 3.7e-3, 1.0, 2.5e4, 1e10):
        s = torch.tensor(scale, dtype=torch.float32)
        assert torch.equal(aq.quantize_fast_twin(x, s, fadd=True), _division(x, s))
