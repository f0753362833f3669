"""The partition of K5 (packed training attention) in plain torch, on the CPU:
the plan's Python twin (``tile_plan``: the classes of every (64, 64) tile pair
and the lists the forward, dq and dk/dv kernels sweep; ``query_tile_order``:
the order of the forward's grid) against the dense mask reduced per tile pair;
the tiled plain forward that sweeps the plan's dq lists with an online softmax
in log2 units (``packed_train_attention_fwd_tiled_ref``) against the one-pass
plain forward and the Pallas forward in interpret mode, in fp32 at rtol 2e-5,
atol 2e-5 for out and atol 2e-5 for lse (``test_torch_train.py``'s forward
tolerance: sums and exponentials in another order); and the tiled plain
backward that follows the plan and the dk/dv split-and-combine order
(``packed_train_attention_bwd_tiled_ref``) against the one-pass plain
gradients and the Pallas kernels' gradients in interpret mode, in fp32 at the
tolerance of ``test_torch_train.py::TestTrainAttentionPlainVersion``: rtol
5e-4, atol 5e-5 (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimedvl_tpu.ops.flash_attention_train import _fwd as j_fwd
from unimedvl_tpu.ops.flash_attention_train import packed_train_attention as j_packed_attention
from unimedvl_tpu_torch.ops import flash_attention_train as fat
from unimedvl_tpu_torch.ops.blockmask import dense_packed_mask, packed_segment_ids

from tests.test_torch_train import LAYOUTS, attention_case

# (sample_lens, split_lens, modes): the training tests' layouts, T 1, 63, 65 and 129 (off the
# tile grid), and documents and spans that start inside a 64-row tile
PLAN_LAYOUTS = LAYOUTS + [
    ([1], [1], ["causal"]),
    ([63], [20, 43], ["causal", "noise"]),
    ([65], [65], ["causal"]),
    ([40, 89], [40, 30, 59], ["causal", "full", "noise"]),
    ([100, 70, 30], [37, 63, 70, 10, 20], ["causal", "noise", "full", "causal", "noise"]),
]


def _ids(layout):
    return [torch.from_numpy(a) for a in packed_segment_ids(*layout)]


def _classes_from_dense(ids):
    """The dense mask reduced per (64, 64) pair on the 128-row grid."""
    T = ids[0].shape[0]
    n64 = 2 * -(-T // 128)
    tiles = torch.zeros(n64 * 64, n64 * 64, dtype=torch.bool)  # rows and keys past T: False
    tiles[:T, :T] = dense_packed_mask(*ids)
    t = tiles.view(n64, 64, n64, 64)
    full, live = t.all(dim=3).all(dim=1), t.any(dim=3).any(dim=1)
    return torch.where(full, fat.FULL, torch.where(live, fat.PARTIAL, fat.DEAD))


class TestBackwardPlan:
    @pytest.mark.parametrize("layout", PLAN_LAYOUTS)
    def test_classes_and_lists_match_the_dense_mask(self, layout):
        ids = _ids(layout)
        want = _classes_from_dense(ids)
        assert torch.equal(fat.tile_classes(*ids).long(), want.long())
        dq_list, dq_count, dkv_list, dkv_count = fat.tile_plan(*ids)
        n64 = want.shape[0]
        assert dq_list.shape == dkv_list.shape == (n64 // 2, n64)
        for x in range(n64 // 2):
            for entries, count, lo, hi in ((dq_list, dq_count, want[2 * x], want[2 * x + 1]),
                                           (dkv_list, dkv_count, want[:, 2 * x],
                                            want[:, 2 * x + 1])):
                live = [(c, int(lo[c]) | int(hi[c]) << 2) for c in range(n64)
                        if lo[c] != fat.DEAD or hi[c] != fat.DEAD]
                got = entries[x].tolist()
                assert count[x] == len(live)
                assert got[:len(live)] == [c | code << fat.ENTRY_SHIFT for c, code in live]
                assert got[len(live):] == [-1] * (n64 - len(live))

    def test_every_row_sees_itself(self):
        """Each diagonal pair is live, so every query tile and key tile below T
        has a list entry; a tile pair inside one causal document below the
        diagonal is full."""
        ids = _ids(([300], [300], ["causal"]))
        cls = fat.tile_classes(*ids)
        assert all(cls[i, i] == fat.PARTIAL for i in range(5))
        assert cls[3, 1] == fat.FULL and cls[1, 3] == fat.DEAD
        assert cls[4, 0] == fat.PARTIAL  # rows 256-319: those past T 300 see nothing


class TestTiledForward:
    """Every row sees itself under the segment rule, so no row below T sees
    nothing; the rows past T that a tile holds (T 1, 63, 65, 129: off the
    64-row grid) see nothing and are dropped from out and lse."""

    @pytest.mark.parametrize("layout,heads", [
        (PLAN_LAYOUTS[0], (4, 2)), (PLAN_LAYOUTS[1], (2, 1)), (PLAN_LAYOUTS[2], (3, 3)),
        (PLAN_LAYOUTS[3], (2, 1)), (PLAN_LAYOUTS[4], (4, 2)), (PLAN_LAYOUTS[5], (2, 1)),
        (PLAN_LAYOUTS[6], (4, 1)), (PLAN_LAYOUTS[7], (2, 2)),
    ])
    def test_matches_plain_forward(self, layout, heads):
        qkv, ids = attention_case(*layout, *heads, D=16, seed=5)
        tq, tk, tv = [torch.from_numpy(a) for a in qkv]
        tids = [torch.from_numpy(a) for a in ids]
        before = dict(fat.counts)
        out, lse = fat.packed_train_attention_fwd_tiled_ref(tq, tk, tv, *tids)
        assert fat.counts == before  # the partition counts as no call of either version
        want = fat.packed_train_attention_ref(tq, tk, tv, *tids)
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
        G = heads[0] // heads[1]
        logits = torch.einsum("ihd,jhd->hij", tq, tk.repeat_interleave(G, dim=1)) * 16**-0.5
        logits = torch.where(dense_packed_mask(*tids), logits, -torch.inf)
        np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, dim=-1).numpy(),
                                   rtol=0, atol=2e-5)

    @pytest.mark.parametrize("layout,heads", [
        (PLAN_LAYOUTS[0], (4, 2)), (PLAN_LAYOUTS[1], (2, 1)), (PLAN_LAYOUTS[4], (2, 2)),
        (PLAN_LAYOUTS[6], (4, 2)),
    ])
    def test_matches_jax_kernel_forward(self, layout, heads):
        """The Pallas ``_fwd`` (out [Hk, G, T_pad, D], lse [Hk, G, T_pad])
        with 64-row blocks in interpret mode."""
        qkv, ids = attention_case(*layout, *heads, seed=6)
        T, H, D = qkv[0].shape
        o, jlse, _ = j_fwd(*[jnp.asarray(a) for a in qkv + ids], 64, 64, True)
        want = np.asarray(o)[:, :, :T].transpose(2, 0, 1, 3).reshape(T, H, D)
        out, lse = fat.packed_train_attention_fwd_tiled_ref(
            *[torch.from_numpy(a) for a in qkv + ids])
        np.testing.assert_allclose(out.numpy(), want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :T].reshape(H, T),
                                   rtol=0, atol=2e-5)

    def test_query_tiles_run_longest_list_first(self):
        """One causal document of 640 rows beside one of 200: the first
        document's last query tiles list the most key tiles; equal counts keep
        the order of the tiles."""
        ids = _ids(([640, 200], [640, 200], ["causal", "causal"]))
        _, dq_count, _, _ = fat.tile_plan(*ids)
        order = fat.query_tile_order(dq_count)
        assert dq_count.tolist() == [2, 4, 6, 8, 10, 2, 4]
        assert order.tolist() == [4, 3, 2, 1, 6, 0, 5]
        assert order.dtype == torch.int32


class TestTiledBackward:
    @pytest.mark.parametrize("layout,heads", [
        (PLAN_LAYOUTS[0], (4, 2)), (PLAN_LAYOUTS[1], (2, 1)), (PLAN_LAYOUTS[3], (2, 2)),
        (PLAN_LAYOUTS[4], (3, 1)), (PLAN_LAYOUTS[5], (4, 2)), (PLAN_LAYOUTS[6], (2, 1)),
        (PLAN_LAYOUTS[7], (4, 1)),
    ])
    def test_matches_plain_gradients(self, layout, heads):
        qkv, ids = attention_case(*layout, *heads, D=16, seed=3)
        cot = np.random.default_rng(4).standard_normal(qkv[0].shape).astype(np.float32)
        tq, tk, tv = [torch.from_numpy(a).requires_grad_(True) for a in qkv]
        tids = [torch.from_numpy(a) for a in ids]
        fat.packed_train_attention_ref(tq, tk, tv, *tids).backward(torch.from_numpy(cot))
        before = dict(fat.counts)
        got = fat.packed_train_attention_bwd_tiled_ref(
            *[torch.from_numpy(a) for a in qkv], *tids, torch.from_numpy(cot))
        assert fat.counts == before  # the partition counts as no call of either version
        for g, w, name in zip(got, (tq.grad, tk.grad, tv.grad), "qkv"):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-4, atol=5e-5,
                                       err_msg=f"grad of {name}")

    @pytest.mark.parametrize("layout,heads", [
        (PLAN_LAYOUTS[0], (4, 2)), (PLAN_LAYOUTS[1], (2, 1)), (PLAN_LAYOUTS[6], (4, 2)),
    ])
    def test_matches_jax_kernel_gradients(self, layout, heads):
        qkv, ids = attention_case(*layout, *heads, seed=1)
        cot = np.random.default_rng(2).standard_normal(qkv[0].shape).astype(np.float32)
        jids = [jnp.asarray(a) for a in ids]

        def loss(q, k, v):
            return jnp.sum(j_packed_attention(q, k, v, *jids, 64, 64, True) * jnp.asarray(cot))

        want = jax.grad(loss, argnums=(0, 1, 2))(*[jnp.asarray(a) for a in qkv])
        got = fat.packed_train_attention_bwd_tiled_ref(
            *[torch.from_numpy(a) for a in qkv + ids], torch.from_numpy(cot))
        for g, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-5,
                                       err_msg=f"grad of {name}")
