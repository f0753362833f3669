"""Builds the package's CUDA sources (``unimedvl_tpu_torch/csrc/*.cu``; shared
device code in ``*.cuh`` beside them) into one shared library with a plain C
interface and loads it with ctypes. Each source compiles in its own ``nvcc``
process, all started together, then one link.

The build runs at the first CUDA launch, never at import: ``import
unimedvl_tpu_torch`` works on a machine with no ``nvcc`` and no GPU. The
library lands in ``<repo>/build/kernels/`` (listed in ``.gitignore``) under a
name keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# argtypes of each exported function: pointers and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints and cut them
_SIGNATURES = {
    "unimedvl_flash_block_attention_bf16": (
        [_P] * 8 + [_I] * 6 + [_L] * 6 + [_I, ctypes.c_float, _P]
    ),
    "unimedvl_flash_block_attention_qpre_bf16": (
        [_P] * 8 + [_I] * 6 + [_L] * 6 + [_I, ctypes.c_float] + [_P] * 4 + [_L] * 2
        + [_P, ctypes.c_float, _P]
    ),
    "unimedvl_flash_cache_block_attention_bf16": (
        [_P] * 7 + [_I] * 8 + [_L] * 12 + [_I, ctypes.c_float]
        + 2 * ([_I] + [_P] * 4 + [_L] * 2 + [_P]) + [ctypes.c_float, _P]
    ),
    "unimedvl_decode_attention_bf16": (
        [_P] * 8 + [_I] * 8 + [_L] * 6 + [ctypes.c_float, _P]
    ),
    "unimedvl_decode_attention_int8": (
        [_P] * 10 + [_I] * 8 + [_L] * 6 + [ctypes.c_float, _P]
    ),
    "unimedvl_silu_mul_quant": [_P] * 4 + [_I] * 2 + [_L] * 2 + [_I, _P],
    "unimedvl_silu_mul_global_pass": [_I] + [_P] * 4 + [_I] * 2 + [_L] * 2 + [_I] * 4 + [_P],
    "unimedvl_w4_matmul": [_P] * 7 + [_I] * 8 + [_P],
    "unimedvl_packed_train_attention_plan": [_P] * 10 + [_I, _P],
    "unimedvl_packed_train_attention_fwd": (
        [_P] * 9 + [_I] * 4 + [_L] * 6 + [ctypes.c_float, _P]
    ),
    "unimedvl_packed_train_attention_bwd_rows": [_P] * 5 + [_I] * 3 + [_L] * 2 + [_P],
    "unimedvl_packed_train_attention_bwd_dq": (
        [_P] * 10 + [_I] * 4 + [_L] * 8 + [ctypes.c_float, _P]
    ),
    "unimedvl_packed_train_attention_bwd_dkv": (
        [_P] * 12 + [_I] * 4 + [_L] * 8 + [ctypes.c_float, _P]
    ),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels cannot be built on this machine"
        )
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # the sources and the headers they share
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libunimedvl_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> str:
    """Wait for every (cmd, Popen); raise with the output of the first that
    failed; return all output."""
    logs, failed = [], None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"{' '.join(cmd)}\n{out}")
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed (exit {proc.returncode}):\n{logs[-1]}"
    if failed is not None:
        raise RuntimeError(failed)
    return "".join(logs)


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its path.
    The compiler's output (``-Xptxas=-v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    tmp.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    try:
        objs, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = tmp / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(str(obj))
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = _run(procs)
        lib = tmp / so.name
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(lib), *objs]
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        so.with_suffix(".log").write_text(
            f"build seconds: {time.perf_counter() - t0:.1f}\n{log}"
        )
        os.replace(lib, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every exported function's types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.unimedvl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.unimedvl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = load_library().unimedvl_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc} ({msg})")
