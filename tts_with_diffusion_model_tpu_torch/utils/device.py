"""The entry points' device rule (the card unless the caller asks for the
CPU), and which process leads (profiles, writes diagnostics and
artifacts)."""

from __future__ import annotations

import os

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def is_global_leader() -> bool:
    """Rank 0 of a process group, or the one process there is."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def is_local_leader() -> bool:
    """Local rank 0 (``$LOCAL_RANK``, as the JAX package reads it), or the
    one process there is."""
    return int(os.environ.get("LOCAL_RANK", 0)) == 0
