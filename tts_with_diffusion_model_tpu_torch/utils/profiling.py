"""Profiler trace capture (counterpart of ``utils/profiling.py`` in the JAX
package, on ``torch.profiler`` instead of ``jax.profiler``):

  - ``trace(log_dir)``: a context manager that writes one Chrome trace of
    its body to ``log_dir/trace.json``;
  - ``annotate(name)``: a named region in the trace;
  - ``StepProfiler``: a trace of ``n_steps`` training steps every ``every``
    steps, each window under ``log_dir/profile/step_<N>/``, the JAX
    package's layout.

The activities are the host's and, where there is a card, CUDA's (kernels,
copies and their launches).  Traces open in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path

import torch

_logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


def _profiler() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _write(prof: torch.profiler.profile, log_dir: Path) -> Path:
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / TRACE_FILE
    prof.export_chrome_trace(str(path))
    _logger.info(f"Wrote profiler trace to {path}")
    return path


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Trace the body of the ``with`` block into ``log_dir/trace.json``."""
    prof = _profiler()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        _write(prof, Path(log_dir))


def annotate(name: str):
    """Named trace region: ``with annotate('train_step'): ...``."""
    return torch.profiler.record_function(name)


class StepProfiler:
    """A trace of ``n_steps`` steps every ``every`` steps (0: never).  In a
    training loop, ``maybe_start(step)`` before the step that will be
    ``step`` and ``maybe_stop(step)`` after it; ``close()`` ends a window
    the loop left open."""

    def __init__(self, log_dir: str | Path, every: int = 0, n_steps: int = 3):
        self.log_dir = Path(log_dir) / "profile"
        self.every = every
        self.n_steps = n_steps
        self._prof: torch.profiler.profile | None = None
        self._start: int | None = None
        self._active_until: int | None = None

    def maybe_start(self, step: int):
        if self.every and step % self.every == 0 and self._active_until is None:
            self._prof = _profiler()
            self._prof.start()
            self._start, self._active_until = step, step + self.n_steps

    def maybe_stop(self, step: int):
        if self._active_until is not None and step + 1 >= self._active_until:
            self.close()

    def close(self):
        """Finish a window in flight and write its trace."""
        if self._active_until is None:
            return
        prof, self._prof, self._active_until = self._prof, None, None
        prof.stop()
        _write(prof, self.log_dir / f"step_{self._start}")
