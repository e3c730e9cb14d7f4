"""Gradient numerics: overflow detection, norms, clipping.

Port of deepspeed_tpu/utils/numerics.py over lists of tensors (the JAX
package walks a pytree): ``has_overflow`` is the fp16 inf/nan scan,
``global_norm`` the L2 (or inf) norm over every element with the
reference's -1.0 sentinel for a non-finite norm, and
``clip_by_global_norm`` the combined clip factor. Each returns device
tensors; nothing here synchronises with the host.
"""

import torch


def has_overflow(tensors):
    """True (a bool scalar tensor) if any tensor holds an inf or a nan."""
    tensors = list(tensors)
    if not tensors:
        return torch.tensor(False)
    flags = [~torch.isfinite(t).all() for t in tensors]
    return torch.stack(flags).any()


def global_norm(tensors, norm_type=2.0):
    """Norm across every element of ``tensors``, in float32; -1.0 if it is
    inf or nan (deepspeed_utils.py:140-147)."""
    tensors = [t.float() for t in tensors]
    if not tensors:
        return torch.tensor(0.0)
    if norm_type == float("inf"):
        norm = torch.stack([t.abs().max() for t in tensors]).max()
    else:
        norm = torch.sqrt(sum(torch.sum(t * t) for t in tensors))
    return torch.where(torch.isfinite(norm), norm, torch.full_like(norm, -1.0))


def clip_by_global_norm(tensors, max_norm, norm=None):
    """Scale ``tensors`` so their global L2 norm is at most ``max_norm``;
    returns ``(scaled tensors, norm)``. A -1.0 sentinel norm leaves them
    untouched (the overflow path skips the step anyway)."""
    tensors = list(tensors)
    if norm is None:
        norm = global_norm(tensors)
    scale = torch.where(
        (norm > max_norm) & (norm > 0), max_norm / norm,
        torch.ones_like(norm),
    )
    return [(t.float() * scale).to(t.dtype) for t in tensors], norm
