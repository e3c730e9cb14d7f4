"""Which head dims the card's attention kernels take, and the engines'
refusal of the rest when they are built.

The flash kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) are compiled at
head dims 64, 128 and 256; their wrappers zero-pad any ``d <= 256`` to the
next of the three (:func:`~deepspeed_tpu_torch.ops.attention.pad_head_dim`).
The paged decode kernel (csrc/paged_decode.cu) takes every head dim from
1 to 128 (instantiated at the multiples of 16, a row's tail zero-filled).
Above 256 the card refuses: no GPT-2/BERT-family configuration has such a
head dim. The JAX package runs any head dim. What the
card cannot take is refused with ``DeepSpeedConfigError`` when an engine
is built on a CUDA device, never mid-step; CPU engines run the plain
versions, which take any head dim.
"""

import torch

from ..config.config import DeepSpeedConfigError
from .attention import FLASH_MAX_HEAD_DIM, FLASH_MIN_SEQ
from .decode_attention import PAGED_DECODE_MAX_HEAD_DIM


def model_head_dim(config):
    """The head dim of a GPT-2 config (``n_embd // n_head``) or a BERT
    config (``hidden_size // num_attention_heads``), or None for a model
    without those fields."""
    width = getattr(config, "n_embd", None) or getattr(
        config, "hidden_size", None)
    heads = getattr(config, "n_head", None) or getattr(
        config, "num_attention_heads", None)
    if not width or not heads:
        return None
    return width // heads


def model_max_positions(config):
    """The longest sequence a GPT-2 (``n_positions``) or BERT
    (``max_position_embeddings``) config takes; 0 for another model."""
    return (getattr(config, "n_positions", None)
            or getattr(config, "max_position_embeddings", None) or 0)


def check_head_dim(head_dim, n_positions, device, fused_decode=False):
    """Refuse, on a CUDA ``device`` (None means CUDA, as the entry points
    default), a model whose attention the kernels cannot take:

    - ``head_dim > 256`` when ``n_positions >= FLASH_MIN_SEQ``, since the
      dispatcher then sends attention to the flash kernels;
    - with ``fused_decode``, a ``head_dim`` above
      ``PAGED_DECODE_MAX_HEAD_DIM`` (128; the paged decode kernel takes
      every head dim up to it).

    Raises ``DeepSpeedConfigError``; returns None when the model runs."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or head_dim is None:
        return
    if head_dim > FLASH_MAX_HEAD_DIM and n_positions >= FLASH_MIN_SEQ:
        raise DeepSpeedConfigError(
            f"head dim {head_dim}: the flash attention kernels take head "
            f"dims up to {FLASH_MAX_HEAD_DIM} on CUDA (zero-padded to 64, "
            f"128 or 256), and this model's n_positions={n_positions} reaches "
            f"FLASH_MIN_SEQ={FLASH_MIN_SEQ}, where attention routes to them"
        )
    if fused_decode and head_dim > PAGED_DECODE_MAX_HEAD_DIM:
        raise DeepSpeedConfigError(
            f"inference.fused_decode: the paged decode kernel takes head "
            f"dims up to {PAGED_DECODE_MAX_HEAD_DIM} on CUDA, got {head_dim}; "
            f"turn inference.fused_decode off for this model"
        )
