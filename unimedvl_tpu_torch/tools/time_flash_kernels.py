"""Time the block flash attention kernels (K1a, K1b, and K1c and K6 where the
checkout has them) of one or more checkouts of this repository on one card,
in one run, so that two versions of ``csrc/flash_block_attention.cu`` (and of
the device code it shares) can be compared:

    python unimedvl_tpu_torch/tools/time_flash_kernels.py PARENT CHANGE CHANGE PARENT
    python unimedvl_tpu_torch/tools/time_flash_kernels.py --verify PARENT CHANGE CHANGE PARENT

Each checkout is timed in a process of its own (it imports that checkout's
package and builds its kernels there), at path shapes of ``chip_smoke.py``,
28/4 heads: K1a image prefill (T 5122 over M 5632, D 128) and ViT (T 5120, D
72, 16 heads); K1b 3-stream denoise steps (T 1026; lens (37, 0, 37) over M
1538 and (2440, 2403, 37) over M 4098); K1c's block partial and its cache
partials (lens (56, 0, 56) over M 512, (2453, 2397, 56) over M 2560); K6 over
the edit cache with the q island and with both islands, beside the route the
port runs there (the k island in torch, the copy into one array, one K1b).
Per shape it prints three medians of 7 single calls (CUDA events) and three
times per call in a run of 20, the same for one
``scaled_dot_product_attention`` call on the same mask (q pre-processed
outside, K/V expanded to the query heads beforehand), and the shape's bound
(the larger of its bytes over 3.35 TB/s and its flops over 989 TFLOP/s), as
one JSON line per checkout after the card's name and power limit.

``--verify`` times K1a at the speculative decode's verify block instead:
T = 8 causal rows per stream after its context, at S 1 with lens 800 over M
1024 and lens 5000 over M 5632, and at S 16 over a serving pool's lens (4
streams near 5150 columns, 4 near 1070, 8 near 750; M 6144)."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

RUN = 20
HBM_BYTES_S, BF16_FLOPS_S = 3.35e12, 989e12


VERIFY_T = 8  # the verify block: the current token and 7 drafts
SERVE_LENS = tuple([5141 + 3 * i for i in range(4)] + [1063 + 5 * i for i in range(4)]
                   + [746 + 4 * i for i in range(8)])


def bound_ms(q_rows, keys, H, Hk, D, pairs=None) -> float:
    """Least time for an attention call: q and out once, K and V once per KV
    head, at the HBM rate, or 4 H D flops per visible (row, key) pair at the
    bf16 peak; ``pairs`` per stream, each row seeing all its keys unless
    given."""
    pairs = [r * k for r, k in zip(q_rows, keys)] if pairs is None else pairs
    n_bytes = sum(4 * r * H * D + 4 * k * Hk * D for r, k in zip(q_rows, keys))
    flops = sum(4.0 * H * D * p for p in pairs)
    return 1e3 * max(n_bytes / HBM_BYTES_S, flops / BF16_FLOPS_S)


def _worker(checkout: str, verify: bool = False) -> None:
    sys.path.insert(0, checkout)
    import torch

    from unimedvl_tpu_torch.ops import flash_attention as fa
    from unimedvl_tpu_torch.ops.rope import rope_cos_sin

    def ms(fn, reps=1):
        for _ in range(2):
            fn()
        times = []
        for _ in range(7):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)

    def both(fn):
        return {"single_ms": [round(ms(fn), 4) for _ in range(3)],
                "run_ms": [round(ms(fn, RUN), 4) for _ in range(3)]}

    def sdpa(q, k, v, mask):
        """SDPA on q [S, T, H, D] over head-major k/v [S, Hk, M, D] with mask [S, T, M]."""
        G = q.shape[2] // k.shape[1]
        qh, kh, vh = q.transpose(1, 2), k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
        m = mask[:, None]
        return both(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=m))

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    def ints(*vals):
        return torch.tensor(vals, dtype=torch.int32, device="cuda")

    def cols(M):
        return torch.arange(M, device="cuda")[None, None]

    out = {"checkout": checkout}
    if verify:
        T = VERIFY_T
        for S, lens, M in ((1, (800,), 1024), (1, (5000,), 5632), (16, SERVE_LENS, 6144)):
            q, kc, vc = randn(S, T, 28, 128, scale=2.0), randn(S, 4, M, 128), randn(S, 4, M, 128)
            ln = ints(*lens)
            rows = torch.arange(T, device="cuda")[None, :, None]
            off = cols(M) - ln[:, None, None]
            mask = (off < 0) | ((off >= 0) & (off <= rows))
            out[f"K1a verify S={S} T={T} M={M}, lens {min(lens)}-{max(lens)}"] = dict(
                both(lambda: fa.flash_block_attention(q, kc, vc, ln, ln, True, T, True)),
                sdpa=sdpa(q, kc, vc, mask),
                bound_ms=bound_ms([T] * S, [n + T for n in lens], 28, 4, 128,
                                  [T * n + T * (T + 1) // 2 for n in lens]))
        print(json.dumps(out), flush=True)
        return
    q, kv = randn(1, 5122, 28, 128, scale=2.0), randn(2, 1, 4, 5632, 128)
    zero, qvl = ints(0), ints(4902)
    out["K1a image prefill"] = dict(
        both(lambda: fa.flash_block_attention(q, kv[0], kv[1], zero, zero, False, qvl, True)),
        sdpa=sdpa(q, kv[0], kv[1], (cols(5632) < 4902).expand(1, 5122, 5632)),
        bound_ms=bound_ms([4902], [4902], 28, 4, 128))
    qv, kvv = randn(1, 5120, 16, 72, scale=2.0), randn(2, 1, 5120, 16, 72)
    lens, bstart = ints(4900), ints(5120)
    out["K1a ViT"] = dict(
        both(lambda: fa.flash_block_attention(qv, kvv[0], kvv[1], lens, bstart, False)),
        sdpa=sdpa(qv, kvv[0].transpose(1, 2), kvv[1].transpose(1, 2),
                  (cols(5120) < 4900).expand(1, 5120, 5120)),
        bound_ms=bound_ms([4900], [4900], 16, 16, 72))
    cos, sin = rope_cos_sin(torch.full((3, 1), 41, device="cuda"), 128, 1e6)
    w = [(1 + 0.1 * torch.randn(128, generator=g, device="cuda")).to(torch.bfloat16)
         for _ in range(4)]
    qp = dict(w_und=w[0], w_gen=w[1], cos=cos, sin=sin, end_row=None, eps=1e-6)
    qd = randn(3, 1026, 28, 128, scale=2.0)
    qd_pre = fa.preprocess_q(qd, qp)
    for name, cap, ln in (("text to image", 512, (37, 0, 37)), ("edit", 3072, (2440, 2403, 37))):
        kc = randn(2, 3, 4, cap + 1026, 128)
        args = (qd, kc[0], kc[1], ints(*ln), ints(cap, cap, cap), False, None, True)
        mask = (cols(cap + 1026) < ints(*ln)[:, None, None]) | (cols(cap + 1026) >= cap)
        out[f"K1b denoise, {name}"] = dict(
            both(lambda: fa.flash_block_attention(*args, q_preproc=qp)),
            sdpa=sdpa(qd_pre, kc[0], kc[1], mask.expand(3, 1026, cap + 1026)),
            bound_ms=bound_ms([1026] * 3, [n + 1026 for n in ln], 28, 4, 128))
    if not hasattr(fa, "lse_counts"):  # a checkout without K1c and K6
        print(json.dumps(out), flush=True)
        return
    kb, vb = randn(3, 1026, 4, 128), randn(3, 1026, 4, 128)
    kw = dict(q_valid_len=0, kv_head_major=True, q_preproc=qp, return_lse=True)
    out["K1c block partial"] = dict(
        both(lambda: fa.flash_block_attention(
            qd, kb.transpose(1, 2), vb.transpose(1, 2), 1026, 1026, False, **kw)),
        sdpa=sdpa(qd_pre, kb.transpose(1, 2), vb.transpose(1, 2),
                  (cols(1026) < 1026).expand(3, 1026, 1026)),
        bound_ms=bound_ms([1026] * 3, [1026] * 3, 28, 4, 128))
    for name, cap, ln in (("text to image", 512, (56, 0, 56)), ("edit", 2560, (2453, 2397, 56))):
        kc = randn(2, 3, 4, cap, 128)
        lens = ints(*ln)
        out[f"K1c cache partial, {name}"] = dict(
            both(lambda: fa.flash_block_attention(qd, kc[0], kc[1], lens, lens, False, **kw)),
            sdpa=sdpa(qd_pre, kc[0], kc[1], (cols(cap) < lens[:, None, None]).expand(3, 1026, cap)),
            bound_ms=bound_ms([1026] * 3, list(ln), 28, 4, 128))
    # K6 (a): the no-update denoise step over the edit cache
    kc = randn(2, 3, 4, 2560, 128)
    ln = ints(2453, 2397, 56)
    kvp = dict(w_und=w[2], w_gen=w[3])
    full = dict(qp, **kvp)
    kb_raw = randn(3, 1026, 4, 128, scale=2.0)
    kb_pre = fa.preprocess_q(kb_raw, full)

    def island_concat_k1b():
        kp = fa.preprocess_q(kb_raw, full)
        k_cat = torch.cat([kc[0], kp.transpose(1, 2)], dim=2)
        v_cat = torch.cat([kc[1], vb.transpose(1, 2)], dim=2)
        return fa.flash_block_attention(qd, k_cat, v_cat, ln, 2560, False, None, True,
                                        q_preproc=qp)

    cat_mask = (cols(3586) < ln[:, None, None]) | (cols(3586) >= 2560)
    k6_sdpa = sdpa(qd_pre, torch.cat([kc[0], kb_pre.transpose(1, 2)], dim=2),
                   torch.cat([kc[1], vb.transpose(1, 2)], dim=2), cat_mask.expand(3, 1026, 3586))
    k6_bound = bound_ms([1026] * 3, [n + 1026 for n in (2453, 2397, 56)], 28, 4, 128)
    out["K6 edit cache, q island"] = dict(
        both(lambda: fa.flash_cache_block_attention(
            qd, kc[0], kc[1], kb_pre, vb, ln, False, q_preproc=qp, cache_head_major=True)),
        sdpa=k6_sdpa, bound_ms=k6_bound)
    out["K6 edit cache, both islands"] = dict(
        both(lambda: fa.flash_cache_block_attention(
            qd, kc[0], kc[1], kb_raw, vb, ln, False, q_preproc=qp, kv_preproc=kvp,
            cache_head_major=True)),
        sdpa=k6_sdpa, bound_ms=k6_bound, island_concat_k1b=both(island_concat_k1b))
    print(json.dumps(out), flush=True)


def main(argv) -> int:
    verify = argv[:1] == ["--verify"]
    argv = argv[1:] if verify else argv
    if len(argv) == 2 and argv[0] == "--worker":
        _worker(argv[1], verify)
        return 0
    if not argv:
        print(__doc__)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for checkout in argv:
        subprocess.run([sys.executable, __file__, *(["--verify"] if verify else []), "--worker",
                        checkout], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
