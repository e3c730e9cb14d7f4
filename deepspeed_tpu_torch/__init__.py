"""deepspeed_tpu_torch: the PyTorch + CUDA port of deepspeed_tpu.

The JAX package (``deepspeed_tpu``) stays the reference; this package
ports it slice by slice to PyTorch, with every Pallas kernel on a
slice's path rewritten by hand in CUDA C++ for Hopper (``csrc/``). This
slice is GPT-2 serving: ``init_inference`` over the paged KV cache with
the prefix cache and fused decode attention. The package imports
``torch`` and never ``jax`` or ``deepspeed_tpu``.

Entry points run on the GPU unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version instead.
"""

from .config.config import DeepSpeedConfig, DeepSpeedConfigError
from .convert import params_from_jax
from .inference.engine import InferenceEngine, init_inference
from .models.gpt2 import GPT2Config, GPT2LMHeadModel

__all__ = [
    "DeepSpeedConfig",
    "DeepSpeedConfigError",
    "GPT2Config",
    "GPT2LMHeadModel",
    "InferenceEngine",
    "init_inference",
    "params_from_jax",
]
