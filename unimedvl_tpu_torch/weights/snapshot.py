"""Training snapshots in the port's own format (the counterpart of
unimedvl_tpu/weights/snapshot.py, which writes orbax checkpoints): one
``torch.save`` of state dicts per snapshot directory. The released-name
safetensors (``weights.loader`` / ``weights.bagel_export``) stay the only
format shared with the reference ecosystem; a snapshot is for resuming a run
and for reloading a model quickly.

A snapshot holds a module's state dict, or a whole ``TrainState``: the
model's state dict (adapters and quantized buffers included), the
optimizer's state dict (AdamW moments and step counts), the step, the EMA
shadow and the latent batch-norm's running statistics.

A train state on a mesh (``make_train_step(mesh=)``, ``make_pp_train_step``)
is written by every rank, its shard to a file of its own
(``snapshot.rank{r}.pt``), with the mesh's axes and sizes, the rank's
coordinates and whether the state is FSDP-sharded; it is restored onto a
state of the same mesh and sharding only, each rank from its own file.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
from torch import nn

_FILE = "snapshot.pt"


def _file(path: str, mesh) -> str:
    return os.path.join(path, _FILE if mesh is None else f"snapshot.rank{mesh.rank}.pt")


def _mesh_record(state) -> Optional[dict]:
    mesh = state.mesh
    if mesh is None:
        return None
    return {"axes": list(mesh.axis_names), "shape": {a: mesh.shape[a] for a in mesh.axis_names},
            "coords": dict(mesh.coords), "fsdp": bool(state.fsdp)}


def _payload(obj) -> dict:
    from unimedvl_tpu_torch.training.trainer import TrainState

    if isinstance(obj, nn.Module):
        return {"kind": "module", "model": obj.state_dict()}
    if isinstance(obj, TrainState):
        bn = obj.bn_state
        return {
            "kind": "train_state",
            "model": obj.model.state_dict(),
            "optimizer": obj.optimizer.state_dict(),
            "step": int(obj.step),
            "ema_params": obj.ema_params,
            "bn_state": None if bn is None else {"mean": bn.mean, "var": bn.var},
            "mesh": _mesh_record(obj),
        }
    raise TypeError(f"save_snapshot takes an nn.Module or a TrainState, got {type(obj).__name__}")


def save_snapshot(path: str, obj: Any) -> str:
    """Write ``obj`` (an ``nn.Module`` or a ``training.trainer.TrainState``)
    to the directory ``path``; returns the file written. The file is written
    beside its final name and renamed over it, so a reader never sees half a
    snapshot. A train state on a mesh: every rank calls this and writes its
    own file."""
    os.makedirs(path, exist_ok=True)
    final = _file(path, getattr(obj, "mesh", None))
    tmp = final + ".tmp"
    torch.save(_payload(obj), tmp)
    os.replace(tmp, final)
    return final


def restore_snapshot(path: str, target: Optional[Any] = None, device="cuda") -> Any:
    """Read the snapshot in directory ``path`` onto ``device`` (the card
    unless the caller names another; it raises without one).

    ``target`` None: the payload as it was saved (a dict: ``kind``,
    ``model`` and, for a train state, ``optimizer``, ``step``,
    ``ema_params``, ``bn_state``). An ``nn.Module``: its state is loaded
    (strict) and it is returned. A ``TrainState`` built over a model of the
    same structure (``make_train_step``'s ``init_state``): model,
    optimizer, step, EMA and batch-norm state are loaded into it and it is
    returned. A target on a mesh reads this rank's file, and raises unless
    the snapshot was written on a mesh of the same axes, sizes and sharding,
    from the rank at the same coordinates."""
    from unimedvl_tpu_torch.training.e2e_vae import BatchNormState
    from unimedvl_tpu_torch.training.trainer import TrainState
    from unimedvl_tpu_torch.weights.loader import _target_device

    device = _target_device(device)
    mesh = getattr(target, "mesh", None)
    name = _file(path, mesh)
    if not os.path.exists(name):
        ranks = sorted(f for f in os.listdir(path) if f.startswith("snapshot.rank"))
        raise ValueError(f"{path} holds no {os.path.basename(name)}"
                         + (f" (a snapshot of a mesh's ranks: {ranks[:4]}...)" if ranks else ""))
    payload = torch.load(name, map_location=device, weights_only=True)
    if target is None:
        return payload
    if isinstance(target, nn.Module):
        target.load_state_dict(payload["model"], strict=True)
        return target
    if not isinstance(target, TrainState):
        raise TypeError(f"restore_snapshot restores into an nn.Module or a TrainState, got "
                        f"{type(target).__name__}")
    if payload["kind"] != "train_state":
        raise ValueError(f"{path} holds a {payload['kind']} snapshot, not a train state")
    saved, want = payload.get("mesh"), _mesh_record(target)
    if saved != want:
        raise ValueError(f"{path} was written on the mesh {saved}; the target state is on "
                         f"{want}: a sharded snapshot restores onto the same mesh and sharding")
    target.model.load_state_dict(payload["model"], strict=True)
    target.optimizer.load_state_dict(payload["optimizer"])
    target.step = payload["step"]
    ema = payload["ema_params"]
    if (ema is None) != (target.ema_params is None):
        raise ValueError("the snapshot and the target disagree on keeping an EMA shadow")
    if ema is not None:
        for name, t in target.ema_params.items():
            t.copy_(ema[name])
    bn = payload["bn_state"]
    target.bn_state = None if bn is None else BatchNormState(bn["mean"], bn["var"])
    return target
