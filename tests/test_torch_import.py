"""The PyTorch port imports without jax, without anything of the JAX package
and without a CUDA toolchain: it keeps its own config, tokenizer set-up and
image preprocessing, and its own copy of the eval text metrics, and builds
its kernels at the first CUDA launch. The
multi-rank modules (``parallel/``, ``tools/dryrun_sp.py``,
``tools/dryrun_mesh.py``, ``tools/dryrun_train.py``) start no process
group and no process when imported, and the HTTP front end
(``inference/server.py``, ``scripts/``) starts no server. The same holds for ``chip_smoke.py``'s
imports."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import sys

def check(what):
    jax = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
    assert not jax, (what, jax)
    ref = sorted(m for m in sys.modules if m == "unimedvl_tpu" or m.startswith("unimedvl_tpu."))
    assert not ref, (what, ref)

import unimedvl_tpu_torch
check("import unimedvl_tpu_torch")
import unimedvl_tpu_torch.config
import unimedvl_tpu_torch.data.tokenizer
import unimedvl_tpu_torch.data.imaging
import unimedvl_tpu_torch.quant
import unimedvl_tpu_torch.ops.flash_attention
import unimedvl_tpu_torch.ops.decode_attention
import unimedvl_tpu_torch.ops.act_quant
import unimedvl_tpu_torch.ops.w4_matmul
import unimedvl_tpu_torch.ops.blockmask
import unimedvl_tpu_torch.ops.flash_attention_train
import unimedvl_tpu_torch.data.packing
import unimedvl_tpu_torch.training.trainer
import unimedvl_tpu_torch.training.lora
import unimedvl_tpu_torch.training.dataset
import unimedvl_tpu_torch.models.bagel
import unimedvl_tpu_torch.weights.loader
import unimedvl_tpu_torch.inference
import unimedvl_tpu_torch.inference.server
import unimedvl_tpu_torch.scripts.common
import unimedvl_tpu_torch.scripts.interactive_vqa
import unimedvl_tpu_torch.scripts.serve_http
import unimedvl_tpu_torch.scripts.interactive_image_generator
import unimedvl_tpu_torch.eval
import unimedvl_tpu_torch.eval.vqa
import unimedvl_tpu_torch.eval.text_metrics
import unimedvl_tpu_torch.models.qwen2_mot
import unimedvl_tpu_torch.inference.pipeline
import unimedvl_tpu_torch.inference.serving
import unimedvl_tpu_torch.inference.programs
import unimedvl_tpu_torch.parallel
import unimedvl_tpu_torch.parallel.mesh
import unimedvl_tpu_torch.parallel.sp_denoise
import unimedvl_tpu_torch.parallel.pp_train
import unimedvl_tpu_torch.tools.dryrun_train
import unimedvl_tpu_torch.tools.dryrun_sp
import unimedvl_tpu_torch.tools.dryrun_mesh
import unimedvl_tpu_torch.utils
import unimedvl_tpu_torch.utils.profiling
import unimedvl_tpu_torch.utils.debugging
import unimedvl_tpu_torch.utils.logging
import unimedvl_tpu_torch.training.e2e_vae
import unimedvl_tpu_torch.weights.bagel_export
import unimedvl_tpu_torch.weights.snapshot
import unimedvl_tpu_torch.data.degradations
import unimedvl_tpu_torch.scripts.export_checkpoint
import unimedvl_tpu_torch.scripts.make_synthetic_ckpt
import unimedvl_tpu_torch.scripts.toy_overfit
check("the port's modules")
import torch.distributed
assert not torch.distributed.is_initialized()  # importing starts no process group
import multiprocessing
assert not multiprocessing.active_children()  # and no rank
import threading
assert threading.active_count() == 1  # no daemon or server thread
import chip_smoke
check("import chip_smoke")
from unimedvl_tpu_torch.ops import cuda_build
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


def test_no_source_line_imports_the_jax_package():
    """No ``import`` line of the port or of chip_smoke.py names ``jax`` or
    ``unimedvl_tpu``; comments and docstrings may."""
    import re

    pattern = re.compile(r"^\\s*(from|import)\\s+(jax|unimedvl_tpu)(\\.|\\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "unimedvl_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            hits = [line for line in f if pattern.match(line)]
        assert not hits, (path, hits)
