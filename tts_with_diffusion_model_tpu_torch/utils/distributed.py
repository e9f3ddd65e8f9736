"""Process bootstrap and leader helpers (counterpart of
``utils/distributed.py`` in the JAX package, ≡ the reference's
``vall_e/utils/distributed.py``).

The JAX package runs one process per host that drives every local device;
the port runs one process per device, launched by ``torchrun`` (``python -m
torch.distributed.run``), whose environment (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) is what the
reference reads too.  Without that environment the process is a world of
one and every helper degenerates (``init_distributed`` returns False, the
collectives return their input).

The backend: ``nccl`` when every rank of a host has a card of its own,
``gloo`` when ranks share a card (NCCL refuses two ranks on one device) or
run on the CPU.
"""

from __future__ import annotations

import logging
import os
from functools import wraps

import torch
import torch.distributed as dist

_logger = logging.getLogger(__name__)

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def choose_backend(device) -> str:
    """``nccl`` for a CUDA device when the host's ranks each have a card,
    else ``gloo``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", 1)))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_distributed(device="cuda") -> bool:
    """Join the process group torchrun's environment describes; True when a
    group is up (already, or now), False for a world of one.  ``device`` is
    what this process computes on: it chooses the backend (above) and, for
    CUDA, the card ``cuda:{LOCAL_RANK % device_count}``."""
    if is_initialized():
        return True
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    backend = choose_backend(device)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    if dist.get_rank() == 0:
        _logger.info("process group: %d ranks over %s (%s)", dist.get_world_size(), backend,
                     "ranks share a card" if backend == "gloo" and
                     torch.device(device).type == "cuda" else "one device per rank")
    return True


def shutdown_distributed() -> None:
    """Tear down the process group this process joined (a no-op for a world
    of one): the last call of every entry point that torchrun may launch
    (serve's leader and followers, train, export, codec train), in a
    ``finally`` of its ``__main__`` block.  A group left up at exit is
    destroyed during the interpreter's teardown, where it aborted a rank
    now and then after its work was done ("terminate called without an
    active exception")."""
    if is_initialized():
        dist.destroy_process_group()


def backend() -> str | None:
    return dist.get_backend() if is_initialized() else None


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """``$LOCAL_RANK`` (torchrun sets it), else 0."""
    return int(os.environ.get("LOCAL_RANK", 0))


def is_global_leader() -> bool:
    return global_rank() == 0


def is_local_leader() -> bool:
    return local_rank() == 0


def _leader_only(check, default=None):
    def decorator(fn):
        @wraps(fn)
        def wrapped(*args, **kwargs):
            if check():
                return fn(*args, **kwargs)
            return default

        return wrapped

    return decorator


def global_leader_only(fn=None, *, default=None):
    """Run only on the global leader; other processes get ``default``."""
    if fn is None:
        return _leader_only(is_global_leader, default)
    return _leader_only(is_global_leader, default)(fn)


def local_leader_only(fn=None, *, default=None):
    if fn is None:
        return _leader_only(is_local_leader, default)
    return _leader_only(is_local_leader, default)(fn)


def barrier():
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj, src: int = 0, group=None):
    """A small picklable object from global rank ``src`` to every rank of
    ``group`` (the world by default): the trainer's stdin commands, the
    server's prepared rows, a tp row's training batches."""
    if world_size() <= 1:
        return obj
    box = [obj if global_rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _scalar_device():
    return (torch.device("cuda", torch.cuda.current_device()) if backend() == "nccl"
            else torch.device("cpu"))


def all_reduce_max_int(value: int, group=None) -> int:
    """The max of a host integer over the ranks of ``group`` (the world by
    default; a collective: each of them calls it at the same point).  The
    length-bucketed loaders agree on a batch's covering bucket with it."""
    if world_size() <= 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_scalar_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())
