"""The entry points' device rule: the card unless the caller asks for the
CPU (which process leads is ``utils/distributed``'s)."""

from __future__ import annotations

import torch

from . import distributed


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if CUDA is asked for and absent.  In
    a process group, "cuda" is this rank's card (``cuda:{LOCAL_RANK %
    device_count}``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if device.type == "cuda" and device.index is None and distributed.world_size() > 1:
        device = torch.device("cuda", distributed.local_rank() % torch.cuda.device_count())
    return device
