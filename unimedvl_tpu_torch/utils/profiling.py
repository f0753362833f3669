"""Per-phase wall timers, a profiler trace and device memory statistics
(port of unimedvl_tpu/utils/profiling.py)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


def _wait(sync) -> None:
    """Wait for ``sync``: a CUDA device (or its index or name) is
    synchronised, a tensor read back with ``.item()`` of one element, a
    callable called and its result waited for."""
    if callable(sync):
        sync = sync()
    if isinstance(sync, torch.Tensor):
        if sync.numel():
            sync.reshape(-1)[0].item()
    elif sync is not None:
        device = torch.device(sync if not isinstance(sync, int) else f"cuda:{sync}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class PhaseTimer:
    """Wall times per named phase and their percentiles. On the card the work
    is asynchronous: give ``phase`` a ``sync`` (a device, a tensor of the
    phase's result, or a callable returning one) to time it to its end."""

    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _wait(sync)
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
            out[name] = {
                "count": int(arr.size),
                "total_s": float(arr.sum()),
                "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)),
            }
        return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block (CPU, and the card's kernels
    when there is one) written to ``log_dir`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, int]:
    """``torch.cuda.memory_stats`` of ``device`` (the current card by
    default); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
