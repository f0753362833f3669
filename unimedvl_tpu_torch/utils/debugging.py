"""Numerical checks for debug runs (port of unimedvl_tpu/utils/debugging.py).

torch has no counterpart of ``jax.experimental.checkify``, which checks inside
a compiled program: :func:`checked` checks a function's outputs after the
call instead, so it says that a non-finite value came out, not which
operation made it. Out-of-range indices already raise in torch (a device-side
assert on the card)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch import nn


def _leaves(tree: Any, prefix: str = ""):
    """(path, tensor) of every tensor in nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")


def find_nonfinite(tree: Any, prefix: str = "") -> Dict[str, int]:
    """{path: count} of the non-finite values of every floating tensor in
    ``tree``: a tensor, nested dicts / lists / tuples of them, or an
    ``nn.Module`` (its ``state_dict``). Reads each count back to the host."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    bad = {}
    for path, t in _leaves(tree, prefix):
        if t.is_floating_point():
            n = int((~torch.isfinite(t)).sum())
            if n:
                bad[path] = n
    return bad


def checked(fn: Callable) -> Callable:
    """``fn`` that raises ``FloatingPointError`` when any floating tensor of
    its output holds a NaN or an infinity (debug runs: every call reads the
    counts back to the host)."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = find_nonfinite(out, "output")
        if bad:
            raise FloatingPointError(f"{getattr(fn, '__name__', fn)}: non-finite values {bad}")
        return out

    return wrapper
