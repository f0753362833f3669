"""The PyTorch port imports without jax and without a CUDA toolchain: it
reuses only the JAX package's jax-free modules and builds its kernels at the
first CUDA launch."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import sys
import unimedvl_tpu_torch
import unimedvl_tpu_torch.ops.flash_attention
import unimedvl_tpu_torch.ops.decode_attention
import unimedvl_tpu_torch.models.bagel
import unimedvl_tpu_torch.weights.loader
import unimedvl_tpu_torch.inference
from unimedvl_tpu_torch.ops import cuda_build
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert cuda_build.load_library.cache_info().currsize == 0  # nothing built
print("ok")
"""


def test_import_needs_no_jax_and_no_nvcc():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    out = subprocess.run(
        [sys.executable, "-c", CODE], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
