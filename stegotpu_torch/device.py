"""The device an entry point runs on when its caller names none."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card.

    The port's entry points run on the card unless the caller asks for the
    CPU. With no CUDA device, None raises rather than running on the CPU:
    a run on the plain versions must be asked for by name.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: stegotpu_torch's entry points run on the card "
            "unless asked otherwise; pass device='cpu' to run the kernels' "
            "plain versions on the CPU")
    return torch.device("cuda")
