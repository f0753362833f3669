"""unimedvl_tpu_torch — the PyTorch and CUDA port of ``unimedvl_tpu`` for one
NVIDIA H100 (Hopper).

The JAX package beside it stays the reference: the port keeps its layouts at
public functions (attention q [S, T, H, D]; KV cache [L, S, Hk, M, D] plus
``lens``) so the tests can hold each module against its JAX counterpart. This
package imports ``torch`` and never ``jax``; it reuses the JAX package's
jax-free modules (``unimedvl_tpu.config``, ``unimedvl_tpu.data.tokenizer``, and
``unimedvl_tpu.data.imaging`` when an image is resized). The CUDA kernels build
lazily at their first launch (ops/cuda_build.py), so importing needs no nvcc.
"""

from unimedvl_tpu.config import BagelConfig, LLMConfig, ViTConfig

__all__ = ["BagelConfig", "LLMConfig", "ViTConfig"]
