"""Generic training loop (counterpart of ``train/trainer.py`` in the JAX
package, ≡ ``vall_e/utils/trainer.py:118-210``).

  - infinite epochs over the train loader, JSON-line stats logging;
  - interactive stdin control: ``eval``, ``save``, ``quit``, ``eval_quit``
    (before the first step), deferred ``cmd@step`` events, ``event``,
    ``event clear`` and ``time [to N]`` ETA; one line is read per step
    (the first before the loop), without blocking;
  - periodic checkpointing every ``save_ckpt_every or eval_every`` and
    periodic eval; ``save_on_quit`` honoured;
  - ``profile_every``: a ``torch.profiler`` trace of ``profile_n_steps``
    steps every ``profile_every`` steps under ``log_dir/profile/step_<N>``
    (``utils/profiling.py``), on the global leader only.

One process on one card: the JAX package's leader election and broadcast
of stdin commands between hosts have nothing to do here.
"""

from __future__ import annotations

import json
import logging
import selectors
import sys
from typing import Callable, Protocol

from ..utils.device import is_global_leader
from ..utils.profiling import StepProfiler
from .engine import Engine, Engines

_logger = logging.getLogger(__name__)


def load_engines(engines: dict[str, Engine], config) -> Engines:
    out = Engines(engines)
    out.setup(config)
    out.load_checkpoint()
    return out


class StdinCommands:
    """Non-blocking line reader over a stream (stdin by default).

    ``poll()`` returns the next line, or "" when none is ready.  A stream
    that is closed, has no file descriptor, or has reached its end is
    dropped for good, so a run under a tool that passes no input neither
    blocks nor polls in a loop."""

    def __init__(self, stream=None):
        self.stream = sys.stdin if stream is None else stream
        self.selector = None
        try:
            self.selector = selectors.DefaultSelector()
            self.selector.register(self.stream, selectors.EVENT_READ)
        except (AttributeError, OSError, ValueError):
            self.close()

    def close(self):
        if self.selector is not None:
            self.selector.close()
        self.selector = None

    def poll(self) -> str:
        if self.selector is None:
            return ""
        try:
            if not self.selector.select(timeout=0):
                return ""
            line = self.stream.readline()
        except (OSError, ValueError):
            line = ""
        if line == "":  # end of stream (or unreadable): stop watching it
            self.close()
            return ""
        s = line.strip()
        _logger.info(f'Get stdin "{s}".')
        return s


def _make_infinite_epochs(dl):
    while True:
        _logger.info("New epoch starts.")
        yield from dl


def logger(data):
    return _logger.info(json.dumps(data, default=str))


class _DeferredCommands:
    """Commands scheduled for a future step via the ``<cmd>@<step>`` syntax:
    ``save@5000`` typed into stdin fires ``save`` when ``global_step``
    reaches 5000.  Entries whose step has already passed are dropped."""

    def __init__(self):
        self._queue: list[tuple[int, str]] = []

    def maybe_defer(self, raw: str) -> bool:
        """If ``raw`` looks like ``cmd@step``, enqueue it and return True."""
        if "@" not in raw:
            return False
        cmd, _, step_str = raw.partition("@")
        try:
            self._queue.append((int(step_str), cmd))
            _logger.info("deferred %r until step %s", cmd, step_str)
        except ValueError as e:
            _logger.error("could not parse deferred command %r: %s", raw, e)
        return True

    def take_due(self, step: int) -> list[str]:
        """Pop and return commands due at ``step``; discard stale ones."""
        due = [cmd for when, cmd in self._queue if when == step]
        self._queue = [(when, cmd) for when, cmd in self._queue if when > step]
        return due

    def describe(self) -> str:
        return ", ".join(f"{cmd}@{when}" for when, cmd in self._queue) or "(none)"

    def clear(self) -> None:
        self._queue.clear()


class EvalFn(Protocol):
    def __call__(self, *, engines: Engines):
        ...


def train(engines_loader: Callable[[], Engines], train_dl, eval_fn: EvalFn,
          logger: Callable = logger) -> Engines:
    """The loop; returns the engines when it ends (``max_iter`` or ``quit``)."""
    engines = engines_loader()
    cfg = engines.cfg
    cfg.dump()
    _logger.info(cfg)

    commands = StdinCommands()
    schedule = _DeferredCommands()
    ckpt_period = cfg.save_ckpt_every or cfg.eval_every
    step_seconds = 0.0
    prof = None
    if cfg.profile_every and is_global_leader():
        prof = StepProfiler(cfg.log_dir, every=cfg.profile_every, n_steps=cfg.profile_n_steps)

    def report_eta(spec: str) -> None:
        # "time" → ETA to max_iter; "time to N" → ETA to step N.
        horizon = cfg.max_iter
        tail = spec.partition(" to ")[2]
        if tail:
            try:
                horizon = int(tail)
            except ValueError:
                _logger.error("bad step in %r — expected 'time to <int>'", spec)
        secs = max(0, horizon - engines.global_step + 1) * step_seconds
        _logger.info("eta %.0fs (%.2fh) to step %d", secs, secs / 3600, horizon)

    def flush_async_stats():
        final = engines.flush_stats()
        if final:
            logger(data=final)
        if prof is not None:
            prof.close()

    try:
        # A command typed before the first step can eval and/or exit at once.
        startup = commands.poll()
        if startup in ("eval", "eval_quit"):
            eval_fn(engines=engines)
        if startup in ("quit", "eval_quit"):
            return engines

        for batch in _make_infinite_epochs(train_dl):
            if engines.global_step >= cfg.max_iter:
                break
            if prof is not None:
                prof.maybe_start(engines.global_step + 1)
            stats = engines.step(batch=batch)
            if prof is not None:
                prof.maybe_stop(engines.global_step)
            step_seconds = stats.get("elapsed_time", 0)
            logger(data=stats)

            step = engines.global_step
            typed = commands.poll()
            if schedule.maybe_defer(typed):
                typed = ""

            # a periodic trigger and an explicit command on the same step
            # give one save/eval; 0 disables the periodic trigger
            want_save = bool(ckpt_period) and step % ckpt_period == 0
            want_eval = bool(cfg.eval_every) and step % cfg.eval_every == 0
            want_quit = False

            for cmd in (typed, *schedule.take_due(step)):
                if cmd in ("event", "event show"):
                    _logger.info("deferred commands: %s", schedule.describe())
                elif cmd == "event clear":
                    schedule.clear()
                elif cmd.startswith("time"):
                    report_eta(cmd)
                elif cmd == "save":
                    want_save = True
                elif cmd == "eval":
                    want_eval = True
                elif cmd == "quit":
                    want_quit = True
                    want_save = want_save or cfg.save_on_quit

            if want_save:
                engines.save_checkpoint()
            if want_eval:
                eval_fn(engines=engines)
            if want_quit:
                break
        flush_async_stats()
        return engines
    finally:
        commands.close()
