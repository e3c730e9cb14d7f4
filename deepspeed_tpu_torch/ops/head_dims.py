"""Which head dims the card's attention kernels take, and the engines'
refusal of the rest when they are built.

The flash kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) are compiled at
head dims 64 and 128; their wrappers zero-pad any ``d <= 128`` to the
next of the two (:func:`~deepspeed_tpu_torch.ops.attention.pad_head_dim`).
The paged decode kernel (csrc/paged_decode.cu) is instantiated at every
multiple of 16 up to 128. The JAX package runs any head dim. What the
card cannot take is refused with ``DeepSpeedConfigError`` when an engine
is built on a CUDA device, never mid-step; CPU engines run the plain
versions, which take any head dim.
"""

import torch

from ..config.config import DeepSpeedConfigError
from .attention import FLASH_MAX_HEAD_DIM, FLASH_MIN_SEQ
from .decode_attention import PAGED_DECODE_HEAD_DIMS


def model_head_dim(config):
    """``n_embd // n_head`` of a GPT-2-style config, or None for a model
    without those fields."""
    n_embd = getattr(config, "n_embd", None)
    n_head = getattr(config, "n_head", None)
    if not n_embd or not n_head:
        return None
    return n_embd // n_head


def check_head_dim(head_dim, n_positions, device, fused_decode=False):
    """Refuse, on a CUDA ``device`` (None means CUDA, as the entry points
    default), a model whose attention the kernels cannot take:

    - ``head_dim > 128`` when ``n_positions >= FLASH_MIN_SEQ``, since the
      dispatcher then sends attention to the flash kernels;
    - with ``fused_decode``, a ``head_dim`` outside
      ``PAGED_DECODE_HEAD_DIMS`` (the paged decode kernel's
      instantiations).

    Raises ``DeepSpeedConfigError``; returns None when the model runs."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or head_dim is None:
        return
    if head_dim > FLASH_MAX_HEAD_DIM and n_positions >= FLASH_MIN_SEQ:
        raise DeepSpeedConfigError(
            f"head dim {head_dim}: the flash attention kernels take head "
            f"dims up to {FLASH_MAX_HEAD_DIM} on CUDA (zero-padded to 64 or "
            f"128), and this model's n_positions={n_positions} reaches "
            f"FLASH_MIN_SEQ={FLASH_MIN_SEQ}, where attention routes to them"
        )
    if fused_decode and head_dim not in PAGED_DECODE_HEAD_DIMS:
        raise DeepSpeedConfigError(
            f"inference.fused_decode: the paged decode kernel takes head "
            f"dims {list(PAGED_DECODE_HEAD_DIMS)} on CUDA, got {head_dim}; "
            f"turn inference.fused_decode off for this model"
        )
