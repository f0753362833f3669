"""Dry run of sharded training on spawned CPU ranks: ``make_train_step(mesh=,
fsdp=)`` and ``make_pp_train_step`` over real collectives
(``torch.distributed``, gloo), at a tiny config with random weights from a
seed, held against the same step on one device. The port's counterpart of
the training part of the JAX package's multi-chip dry run.

    python -m unimedvl_tpu_torch.tools.dryrun_train --device cpu --dp 2 --tp 2
    python -m unimedvl_tpu_torch.tools.dryrun_train --device cpu --dp 2 --tp 2 --fsdp
    python -m unimedvl_tpu_torch.tools.dryrun_train --device cpu --pipe 2 --tp 2

Prints one JSON line: the mesh, the loss of the one-device step and of the
mesh step, the largest relative difference of any parameter after the step,
and whether the replicated tensors are bit-equal on every rank. Exits
non-zero if they disagree.

:func:`run_train_cases` is what the tests spawn (tests/test_torch_train_mesh.py,
tests/test_torch_pp_train.py): one set of ranks runs a list of cases, so
that a test file pays for one spawn per mesh shape. The functions live here
because a spawned child imports its target's module, and the test modules
import jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from unimedvl_tpu_torch.parallel import mesh as pmesh

LAYERS = "language_model.model.layers."


def global_name(name: str, first_layer: int) -> str:
    """A stage model's parameter name as the whole model names it."""
    if not name.startswith(LAYERS) or not first_layer:
        return name
    i, rest = name[len(LAYERS):].split(".", 1)
    return f"{LAYERS}{int(i) + first_layer}.{rest}"


def rank_part(name: str, whole: np.ndarray, llm, shape: Dict[str, int], coords: Dict[str, int],
              fsdp: bool = False) -> np.ndarray:
    """The part of the whole model's tensor ``name`` (numpy or torch; the
    part comes back as the same) that the rank at ``coords`` of a mesh of
    ``shape`` holds: its "model" ranges (``parallel.mesh.leaf_ranges``),
    then under ``fsdp`` its "data" slice."""
    t = whole if torch.is_tensor(whole) else torch.from_numpy(np.array(whole))
    t = pmesh.take_ranges(t, pmesh.leaf_ranges(name, t.shape, llm, shape.get("model", 1),
                                                coords.get("model", 0)))
    if fsdp:
        fake = pmesh.Mesh(tuple(shape), dict(shape), 0, dict(coords), {a: None for a in shape})
        t = pmesh.take_ranges(t, pmesh.fsdp_range(name, t.shape, fake))
    return t if torch.is_tensor(whole) else t.numpy()


def replicated(name: str, llm, shape: Dict[str, int], fsdp: bool, pipe: bool) -> bool:
    """Whether every rank of the mesh holds the whole tensor ``name``."""
    if pipe and name.startswith(LAYERS):
        return shape.get("pipe", 1) == 1
    tp = shape.get("model", 1)
    if pmesh.leaf_ranges(name, (2 * tp, 2 * tp), llm, tp, 0) is not None:
        return False
    return not (fsdp and pmesh.fsdp_dim(name) is not None)


def checksums(model) -> Dict[str, int]:
    """An exact, order-free checksum of every parameter's bits."""
    words = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return {n: int(torch.sum(p.detach().view(words[p.element_size()]), dtype=torch.int64))
            for n, p in model.named_parameters()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy (a CPU fp32 tensor's ``.numpy()`` shares its storage, which a
    later step updates)."""
    return t.detach().float().cpu().numpy().copy()


def _torch_noises(noises):
    if noises is None:
        return None
    return [None if n is None else torch.from_numpy(np.array(n)) for n in noises]


def _place(whole, mesh, case):
    if case.get("pipe"):
        from unimedvl_tpu_torch.parallel.pp_train import place_params_pp

        return place_params_pp(whole, mesh)
    return pmesh.place_params(whole, mesh)


def _make_step(model, mesh, case):
    from unimedvl_tpu_torch.training import trainer

    opt = trainer.make_optimizer(learning_rate=case.get("lr", 1e-3))
    cfg = model.whole_config
    if case.get("pipe"):
        return trainer.make_pp_train_step(cfg, model, mesh, optimizer=opt,
                                          ema_decay=case.get("ema"), graphs=case.get("graphs"))
    return trainer.make_train_step(cfg, model, optimizer=opt, accum_steps=case.get("accum", 1),
                                   ema_decay=case.get("ema"), mesh=mesh,
                                   fsdp=case.get("fsdp", False), graphs=case.get("graphs"))


def _state_result(state, mesh, case) -> Dict:
    model = state.model
    first = getattr(model.language_model.model, "first_layer", 0)
    out = {
        "coords": dict(mesh.coords),
        "params": {global_name(n, first): _numpy(p) for n, p in model.named_parameters()},
        "checksums": {global_name(n, first): c for n, c in checksums(model).items()},
        "step": state.step,
    }
    if state.ema_params is not None:
        out["ema"] = {global_name(n, first): _numpy(e) for n, e in state.ema_params.items()}
    moments = {}
    names = {id(p): n for n, p in model.named_parameters()}
    for p, st in state.optimizer.state.items():
        moments[global_name(names[id(p)], first)] = (tuple(st["exp_avg"].shape),
                                                     tuple(st["exp_avg_sq"].shape))
    out["moments"] = moments
    return out


def run_step_case(whole, mesh, case) -> Dict:
    """``case["steps"]`` calls of the step on a rank model placed from
    ``whole``: ``case["batches"]`` / ``case["noises"]`` one entry per call.
    With ``case["grads"]`` the first call's gradients (``compute_gradients``)
    are returned instead of stepping. With ``case["snapshot"]`` (a
    directory): a snapshot after the first call, the second call, then a
    fresh rank model restored from the snapshot takes the second call again
    (``resumed_equal``: every parameter, moment and EMA tensor bit-equal),
    and a restore onto a mesh of another shape must raise (``other_mesh``:
    its message). ``whole_unchanged``: the whole model the rank's was placed
    from (with views) is bit-equal after the steps."""
    from unimedvl_tpu_torch.training import trainer

    whole_sums = checksums(whole)
    model = _place(whole, mesh, case)
    step, init_state = _make_step(model, mesh, case)
    state = init_state()
    batches, noises = case["batches"], case.get("noises") or [None] * len(case["batches"])
    if case.get("grads"):
        if case.get("pipe"):
            loss, _ = trainer.pp_compute_gradients(state, model.whole_config, batches[0],
                                                   noises=_torch_noises(noises[0]))
        else:
            loss, _ = trainer.compute_gradients(state, batches[0], noises=_nested(noises[0]),
                                                accum_steps=case.get("accum", 1))
        first = getattr(model.language_model.model, "first_layer", 0)
        return {"loss": float(loss), "coords": dict(mesh.coords),
                "grads": {global_name(n, first): _numpy(p.grad)
                          for n, p in model.named_parameters() if p.grad is not None}}
    from unimedvl_tpu_torch.inference import programs

    losses, buckets, ema_err = [], [], 0.0
    decay = case.get("ema")
    for i in range(case.get("steps", len(batches))):
        prev = None if decay is None else {n: e.clone() for n, e in state.ema_params.items()}
        state, loss = step(state, batches[i], noises=_nested(noises[i]))
        losses.append(float(loss))
        buckets.append(sum(p.family == "train" for p in programs.programs()))
        if case.get("first_params") and i == 0:
            first = _state_result(state, mesh, case)
            first_params, first_sums = first["params"], first["checksums"]
        if prev is not None:  # the recurrence, on this rank's shards
            params = dict(model.named_parameters())
            ema_err = max(ema_err, max(
                float((state.ema_params[n] - (decay * e + (1 - decay) * params[n].detach()))
                      .abs().max()) for n, e in prev.items()))
        if case.get("snapshot") and i == 0:
            from unimedvl_tpu_torch.weights.snapshot import save_snapshot

            save_snapshot(case["snapshot"], state)
    out = _state_result(state, mesh, case)
    out["losses"], out["ema_recurrence_err"] = losses, ema_err
    out["train_buckets"] = buckets  # a program's buckets after each call
    if case.get("first_params"):  # the parameters after the first call, and their checksums
        out["first_params"], out["first_checksums"] = first_params, first_sums
    # the placed model's views never moved the whole model (init_state copies)
    out["whole_unchanged"] = checksums(whole) == whole_sums
    if case.get("snapshot"):
        out.update(_resume(whole, mesh, case, state))
    return out


def _nested(noises):
    """Noises as numpy (a list per sequence, or a list of such lists under
    accumulation) as tensors."""
    if noises is None:
        return None
    if noises and isinstance(noises[0], (list, tuple)):
        return [_torch_noises(n) for n in noises]
    return _torch_noises(noises)


def _resume(whole, mesh, case, straight) -> Dict:
    from unimedvl_tpu_torch.weights.snapshot import restore_snapshot

    model = _place(whole, mesh, case)
    step, init_state = _make_step(model, mesh, case)
    state = restore_snapshot(case["snapshot"], init_state(), device="cpu")
    restored_step = state.step
    state, loss = step(state, case["batches"][1], noises=_nested((case.get("noises") or
                                                                   [None, None])[1]))
    a, b = checksums(state.model), checksums(straight.model)
    same = a == b
    sa, sb = state.optimizer.state_dict()["state"], straight.optimizer.state_dict()["state"]
    same = same and all(torch.equal(sa[k][m], sb[k][m]) for k in sb for m in sb[k])
    if straight.ema_params is not None:
        same = same and all(torch.equal(state.ema_params[n], e)
                            for n, e in straight.ema_params.items())
    # a target on a mesh of another shape (no collective runs before the check)
    world = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    sizes = tuple(mesh.shape[a] for a in mesh.axis_names)
    other = (world,) + (1,) * (len(sizes) - 1)  # every rank over the first axis
    other_shape = dict(zip(mesh.axis_names, other if other != sizes else other[::-1]))
    coords = dict(zip(mesh.axis_names, (int(c) for c in np.unravel_index(
        mesh.rank, tuple(other_shape.values())))))
    other = pmesh.Mesh(mesh.axis_names, other_shape, mesh.rank, coords,
                       {a: None for a in mesh.axis_names})
    message = None
    try:
        omodel = pmesh.place_params(whole, other)
        _, oinit = _make_step(omodel, other, case)
        restore_snapshot(case["snapshot"], oinit(), device="cpu")
    except ValueError as e:
        message = str(e)
    return {"restored_step": restored_step, "resumed_loss": float(loss), "resumed_equal": same,
            "other_mesh": message}


def run_train_cases(rank: int, world: int, axes, sizes, models, cases: List[Dict]) -> list:
    """On one rank of a mesh ``axes`` x ``sizes``: each case of ``cases`` on
    the whole CPU model ``models[case["model"]]`` (:func:`run_step_case`).
    A case is a dict: ``batches`` (one stacked numpy batch per call, or a
    list of them per call under ``accum``), ``noises`` (numpy, per call per
    sequence), and the step's options ``lr``, ``accum``, ``ema``, ``fsdp``,
    ``pipe``, ``steps``, ``grads``, ``snapshot``, ``graphs`` (the step's
    route, for ``make_train_step`` and ``make_pp_train_step`` alike),
    ``first_params`` (the parameters and checksums after the first call
    too)."""
    mesh = pmesh.make_mesh(axes, sizes)
    return [run_step_case(models[case.get("model", "base")], mesh, case) for case in cases]


# -- the card's two-process programs (chip_smoke.py) ----------------------------------------

EMBED = "language_model.model.embed_tokens.weight"
_WORDS = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}


def to_host(t: torch.Tensor):
    """A tensor as (dtype name, numpy array of its bits): pickled by value
    across the process boundary (a torch tensor there would be shared by a
    file descriptor that dies with the rank) and exact in bf16."""
    t = t.detach().cpu().contiguous()
    return str(t.dtype).split(".")[-1], t.view(_WORDS[t.dtype]).numpy()


def from_host(packed) -> torch.Tensor:
    """The tensor :func:`to_host` packed."""
    name, bits = packed
    return torch.from_numpy(bits).view(getattr(torch, name))


def _watched_parts(model, mesh, watch, embed_ids, fsdp: bool) -> Dict:
    """This rank's part of the gradient of each watched tensor it holds
    (:func:`to_host`), by global name; of the embedding only the rows of
    ``embed_ids`` in its vocab slice: ``{"ids", "rows"}``."""
    first = getattr(model.language_model.model, "first_layer", 0)
    params = {global_name(n, first): p for n, p in model.named_parameters()}
    out = {}
    for name in watch:
        if name not in params:
            continue  # a layer of another pipeline stage
        g = params[name].grad
        if name == EMBED:
            lm = model.language_model
            v0 = getattr(lm, "vocab_start", 0)
            ids = [i for i in embed_ids if v0 <= i < v0 + g.shape[0]]
            rows = g[torch.tensor([i - v0 for i in ids], dtype=torch.long, device=g.device)]
            out[name] = {"ids": ids, "rows": to_host(rows)}
        else:
            out[name] = to_host(g)
    return out


def card_train_rank(rank: int, world: int, cfg, seed: int, seqs, noises, programs, watch,
                    embed_ids, steps: int, device: str = "cuda",
                    dtype: torch.dtype = torch.bfloat16) -> List[Dict]:
    """One rank of the card's training programs (every rank on cuda:0, joined
    by gloo; chip_smoke.py's mesh training phase): for each program (a dict:
    ``name``, ``axes``, ``sizes``, ``fsdp``, ``pipe``) the rank builds its
    shard of the seeded random model (``dryrun_mesh.random_rank_model``, then
    its stage's layers under ``pipe``), takes the gradients of the global
    batch ``seqs`` (prepared sequences on the host, ``noises`` their flow
    noise) and the update, then ``steps`` more steps. Returns per program:
    the loss of the gradient step and of each step, this rank's part of each
    watched gradient (:func:`_watched_parts`), the checksum of every
    parameter after the steps, K5's launches (and the plain versions'
    calls), the rank's peak GiB and the seconds. ``device="cpu"`` rehearses
    it on CPU tensors (the plain versions run there)."""
    import gc

    from unimedvl_tpu_torch.ops import flash_attention_train as fat
    from unimedvl_tpu_torch.parallel.pp_train import keep_stage_layers
    from unimedvl_tpu_torch.tools.dryrun_mesh import random_rank_model
    from unimedvl_tpu_torch.training import trainer

    cuda = device == "cuda"
    device = torch.device("cuda", 0) if cuda else torch.device(device)
    if cuda:
        torch.cuda.set_device(0)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    seqs = [{k: v.to(device) for k, v in s.items()} for s in seqs]
    noises = [None if n is None else n.to(device) for n in noises]
    out = []
    for prog in programs:
        mesh = pmesh.make_mesh(prog["axes"], prog["sizes"])
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = random_rank_model(cfg, mesh, seed, device, dtype=dtype, with_vae=True,
                                  llm2vae_zero=False)
        if prog.get("pipe"):
            keep_stage_layers(model, mesh)
            step, init_state = trainer.make_pp_train_step(cfg, model, mesh)
        else:
            step, init_state = trainer.make_train_step(cfg, model, mesh=mesh,
                                                       fsdp=prog.get("fsdp", False))
        state = init_state()
        sync()
        build_s = time.perf_counter() - t0
        for key in ("fwd", "bwd_dq", "bwd_dkv", "plain"):
            fat.counts[key] = 0
        t1 = time.perf_counter()
        if prog.get("pipe"):
            loss, _ = trainer.pp_compute_gradients(state, cfg, seqs, noises=noises)
        else:
            loss, _ = trainer.compute_gradients(state, seqs, noises=noises)
        losses = [float(loss)]
        grads = _watched_parts(model, mesh, watch, embed_ids, prog.get("fsdp", False))
        trainer._apply_update(state, None)
        for _ in range(steps):
            state, loss = step(state, seqs, noises=noises)
            losses.append(float(loss))
        sync()
        first = getattr(model.language_model.model, "first_layer", 0)
        out.append(dict(
            name=prog["name"], coords=dict(mesh.coords), losses=losses, grads=grads,
            checksums={global_name(n, first): c for n, c in checksums(model).items()},
            launches={k: fat.counts[k] for k in ("fwd", "bwd_dq", "bwd_dkv", "plain")},
            layers=len(model.language_model.model.layers),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
            build_s=build_s,
            steps_s=time.perf_counter() - t1))
        del model, state, step, init_state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


# -- the command line ---------------------------------------------------------------------

def tiny_config(layers: int = 2):
    """The tests' TINY geometry (tests/test_pipeline.py) at ``layers`` layers."""
    from unimedvl_tpu_torch.tools.dryrun_mesh import TINY

    return dataclasses.replace(TINY, llm=dataclasses.replace(TINY.llm, num_hidden_layers=layers))


def tiny_batches(cfg, n: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A stacked batch of ``n`` packed sequences of text, a ViT image and
    latent tokens (``data.packing.pack_training_batch``, 16-row padding)."""
    from unimedvl_tpu_torch.data.packing import pack_training_batch
    from unimedvl_tpu_torch.training.dataset import stack_packed

    rng = np.random.default_rng(seed)
    vp = cfg.vit.patch_size ** 2 * 3
    out = []
    for i in range(n):
        sample = [
            {"type": "text", "ids": [1, 5 + i, 9, 3, 2], "loss": True},
            {"type": "vit", "patch_tokens": rng.standard_normal((16, vp)).astype(np.float32),
             "pos_ids": np.arange(16)},
            {"type": "vae", "clean_tokens":
                rng.standard_normal((4, cfg.patch_latent_dim)).astype(np.float32),
             "pos_ids": np.arange(4), "timestep_raw": 0.3 + 0.1 * i, "loss": True},
        ]
        out.append(pack_training_batch([sample], pad_multiple=16))
    return stack_packed(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cpu: spawned gloo ranks")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--pipe", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device != "cpu":
        sys.exit("dryrun_train: meshes of several ranks run on the CPU (--device cpu); the card "
                 "runs the training mesh programs through chip_smoke.py")
    from unimedvl_tpu_torch.models import bagel
    from unimedvl_tpu_torch.training import trainer

    pipe = args.pipe > 1
    cfg = tiny_config(4 if pipe else 2)
    whole = bagel.Bagel(cfg, device="cpu", dtype=torch.float32, with_vae=False)
    bagel.init_random_(whole, torch.Generator().manual_seed(args.seed), llm2vae_zero=False)
    n = 2 * args.dp
    batch = tiny_batches(cfg, n)
    g = torch.Generator().manual_seed(args.seed + 1)
    shapes = trainer._noise_shapes(batch)
    noises = [None if s is None else torch.randn(s, generator=g).numpy() for s in shapes]
    if pipe:
        axes = ("data", "pipe", "model") if args.dp > 1 else (
            ("pipe", "model") if args.tp > 1 else ("pipe",))
        sizes = {"data": args.dp, "pipe": args.pipe, "model": args.tp}
        sizes = tuple(sizes[a] for a in axes)
    else:
        axes, sizes = ("data", "model"), (args.dp, args.tp)
    case = dict(batches=[batch], noises=[noises], pipe=pipe, fsdp=args.fsdp, steps=1)
    t0 = time.perf_counter()
    ranks = pmesh.run_on_ranks(run_train_cases, int(np.prod(sizes)), axes, sizes,
                               {"base": whole}, [case])
    seconds = time.perf_counter() - t0

    one = bagel.Bagel(cfg, device="cpu", dtype=torch.float32, with_vae=False)
    one.load_state_dict(whole.state_dict())
    step, init_state = trainer.make_train_step(cfg, one,
                                               trainer.make_optimizer(learning_rate=1e-3))
    _, want_loss = step(init_state(), batch, noises=_torch_noises(noises))
    want = {k: v.numpy() for k, v in one.state_dict().items()}
    shape = dict(zip(axes, sizes))
    worst = 0.0
    for r in ranks:
        r = r[0]
        for name, got in r["params"].items():
            part = rank_part(name, want[name], cfg.llm, shape, r["coords"], args.fsdp)
            worst = max(worst, float(np.max(np.abs(got - part) / (np.abs(part) + 1e-6))))
    reps = [n for n in ranks[0][0]["checksums"]
            if replicated(n, cfg.llm, shape, args.fsdp, pipe)]
    equal = all(r[0]["checksums"][n] == ranks[0][0]["checksums"][n] for r in ranks
                for n in reps if n in r[0]["checksums"])
    losses = [r[0]["losses"][0] for r in ranks]
    ok = (equal and worst < 1e-3 and all(abs(x - float(want_loss)) < 1e-4 for x in losses))
    print(json.dumps({"mesh": shape, "fsdp": args.fsdp, "one_device_loss": float(want_loss),
                      "mesh_losses": losses, "max_param_rel_diff": worst,
                      "replicated_bit_equal": equal, "seconds": seconds, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
