"""Profiling, debugging and logging helpers (port of unimedvl_tpu/utils/)."""

from unimedvl_tpu_torch.utils.debugging import checked, find_nonfinite
from unimedvl_tpu_torch.utils.logging import get_logger
from unimedvl_tpu_torch.utils.profiling import PhaseTimer, device_memory_stats, trace

__all__ = ["PhaseTimer", "device_memory_stats", "trace", "get_logger", "checked",
           "find_nonfinite"]
