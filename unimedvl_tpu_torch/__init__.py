"""unimedvl_tpu_torch — the PyTorch and CUDA port of ``unimedvl_tpu`` for one
NVIDIA H100 (Hopper).

The JAX package beside it stays the reference: the port keeps its layouts at
public functions (attention q [S, T, H, D]; KV cache [L, S, Hk, M, D] plus
``lens``) so the tests can hold each module against its JAX counterpart. This
package imports ``torch``, never ``jax`` and nothing of the JAX package: it
keeps its own config tree (``config``), tokenizer set-up (``data.tokenizer``)
and image preprocessing (``data.imaging``). The CUDA kernels build lazily at
their first launch (ops/cuda_build.py), so importing needs no nvcc.
"""

from unimedvl_tpu_torch.config import BagelConfig, LLMConfig, ViTConfig

__all__ = ["BagelConfig", "LLMConfig", "ViTConfig"]
