"""Logging setup: stdout + ``log_dir/log.txt``, rank-stamped.

Copy of ``utils/logging.py`` in the JAX package (the counterpart of the
reference's ``setup_logging``): the same dual sink and rank-in-format
convention, so JSON-line scraping of training logs keeps working.  The rank
is ``torch.distributed``'s when a process group is up, else 0.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path


class _RankFilter(logging.Filter):
    def __init__(self, rank: int):
        super().__init__()
        self.rank = rank

    def filter(self, record):
        record.rank = self.rank
        return True


def global_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def setup_logging(log_dir: str | Path | None = None, level: str = "INFO"):
    handlers: list[logging.Handler] = []

    stdout_handler = logging.StreamHandler(sys.stdout)
    stdout_handler.setLevel(level)
    stdout_handler.setFormatter(
        logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - GR=%(rank)s - %(message)s"
        )
    )
    handlers.append(stdout_handler)

    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        file_handler = logging.FileHandler(str(log_dir / "log.txt"))
        file_handler.setLevel(logging.INFO)
        file_handler.setFormatter(
            logging.Formatter(
                "%(asctime)s - %(name)s - %(levelname)s - GR=%(rank)s - %(message)s"
            )
        )
        handlers.append(file_handler)

    rank_filter = _RankFilter(global_rank())
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers = []
    for h in handlers:
        h.addFilter(rank_filter)
        root.addHandler(h)
