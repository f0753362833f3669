"""The port's ``utils/`` (the counterpart of unimedvl_tpu/utils/, which the
JAX package's front ends import): the phase timer, the non-finite scan and
check, the logger, the profiler trace and the memory statistics, on the CPU."""

import json
import logging
import os

import pytest
import torch
from torch import nn

from unimedvl_tpu_torch import utils
from unimedvl_tpu_torch.utils import debugging, profiling


def test_phase_timer_counts_and_syncs_on_a_tensor():
    timer = utils.PhaseTimer()
    for _ in range(3):
        with timer.phase("decode", sync=torch.ones(2)):
            torch.ones(8).sum()
    with timer.phase("prefill", sync=lambda: torch.zeros(1)):
        pass
    s = timer.summary()
    assert s["decode"]["count"] == 3 and s["prefill"]["count"] == 1
    assert s["decode"]["total_s"] >= s["decode"]["p50_s"] >= 0
    assert set(s["decode"]) == {"count", "total_s", "mean_s", "p50_s", "p95_s"}


def test_find_nonfinite_planted_nan_in_a_module_and_a_tree():
    lin = nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight[1, 2] = float("nan")
        lin.bias[0] = float("inf")
    assert utils.find_nonfinite(lin) == {"['weight']": 1, "['bias']": 1}
    tree = {"a": torch.ones(2), "b": [torch.tensor([1.0, float("nan")]), torch.arange(3)]}
    assert utils.find_nonfinite(tree, "x") == {"x['b'][0]": 1}


def test_checked_raises_on_a_nonfinite_output():
    ok = utils.checked(lambda x: {"y": x * 2})
    assert torch.equal(ok(torch.ones(2))["y"], torch.full((2,), 2.0))
    bad = utils.checked(lambda x: x / 0)
    with pytest.raises(FloatingPointError, match="non-finite"):
        bad(torch.ones(2))
    assert debugging.checked(lambda: torch.arange(3))().tolist() == [0, 1, 2]  # integers pass


def test_logger_name_and_single_handler():
    log = utils.get_logger("unimedvl_tpu_torch.test")
    assert log.name == "unimedvl_tpu_torch.test"
    root = logging.getLogger("unimedvl_tpu_torch")
    n = len(root.handlers)
    utils.get_logger()
    assert len(root.handlers) == n == 1 and root.level == logging.INFO


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        assert "allocated_bytes.all.current" in utils.device_memory_stats()
    else:
        assert utils.device_memory_stats() == {}
