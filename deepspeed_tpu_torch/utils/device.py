"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` they take ``"cuda"`` and raise when there is no GPU, rather
than quietly running the plain PyTorch versions of the kernels.
"""

import torch


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means ``"cuda"``, which
    raises without a GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'"
        )
    return device
