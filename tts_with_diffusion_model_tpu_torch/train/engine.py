"""Engine / Engines: the training runtime (counterpart of ``train/engine.py``
in the JAX package, which rebuilds the reference's DeepSpeed wrapper).

  - ``Engine`` owns one model's parameters, optimizer state, EMA and step,
    and steps, saves and loads itself under ``ckpt_dir/<name>``;
  - ``Engines`` is a dict of engines with a combined ``step(batch)``
    returning a flat stats dict {loss, lr, grad_norm, elapsed_time,
    engine_step, ...}; the global step is the largest engine step.

The update is optax's, written out, because torch's own helpers differ:
  - ``clip_by_global_norm``: scale by ``max_norm / norm`` only when
    ``norm >= max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm);
  - Adam (b1 0.9, b2 0.999, eps 1e-8) at the WarmupDecayLR value of the
    update count *before* it increments, so the first update uses
    ``warmup_min_lr``;
  - ``MultiSteps`` accumulation: the running mean of k micro-batches'
    gradients, clipped and applied once; ``step`` counts micro-batches;
  - EMA ``d·e + (1−d)·p`` after every micro-batch, from a copy of the
    initial parameters;
  - ``grad_norm`` in the stats is the micro-batch gradient's pre-clip norm,
    and ``lr`` is the schedule at the engine step after the increment;
  - ``trainable_filter`` (``optax.multi_transform`` over clip + Adam): a
    predicate on each parameter's JAX path (``params/base/text_emb/
    embedding``); the others get zero updates and no Adam state, and the
    clipping norm is taken over the trainable gradients only.  Accumulation
    stays outside the mask, as ``MultiSteps`` does.

Checkpoints are ``torch.save`` files ``ckpt_dir/<name>/step_<8 digits>.pt``
(the JAX package writes orbax directories of the same names; the bundle
export is a later slice).
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Callable, Protocol

import numpy as np
import torch

from ..convert import tree_path, torch_params_to_jax

_logger = logging.getLogger(__name__)

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """``optax.linear_schedule`` at ``count``, in float32 as optax computes
    it (at the gen4c D3PM recipe's 1e-9 → 5e-4 warm-up, float64 would differ
    by up to 7.3e-11, 4.8% of the first update's lr)."""
    f = np.float32
    if steps <= 0:
        return float(f(init))
    frac = f(1) - f(min(max(count, 0), steps)) / f(steps)
    return float(f(init - end) * frac + f(end))


def warmup_decay_schedule(warmup_min_lr: float, warmup_max_lr: float,
                          warmup_num_steps: int, total_num_steps: int) -> Callable[[int], float]:
    """DeepSpeed WarmupDecayLR: linear warmup min→max, then linear decay → 0
    (``optax.join_schedules`` of two linear schedules)."""
    decay_steps = max(total_num_steps - warmup_num_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_num_steps:
            return _linear(warmup_min_lr, warmup_max_lr, warmup_num_steps, count)
        return _linear(warmup_max_lr, 0.0, decay_steps, count - warmup_num_steps)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class LossFn(Protocol):
    def __call__(self, module: torch.nn.Module, batch: dict,
                 generator: torch.Generator | None) -> tuple[torch.Tensor, dict]:
        ...


def batch_to_device(batch: dict, device) -> dict:
    """numpy arrays of a collated batch → tensors on ``device`` (integers as
    int64, floats as float32); the path and speaker lists are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            t = t.long() if not t.is_floating_point() else t.float()
            out[k] = t.to(device, non_blocking=True)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
    return out


def jax_paths(module: torch.nn.Module) -> list[str]:
    """Each parameter's path in the JAX package's tree, in
    ``named_parameters`` order: ``params/`` and the flax path of the
    denoiser's parameter for the diffusion family (whose JAX engine holds
    the denoiser's tree), of the model's for the others."""
    root = getattr(module, "denoiser", module)
    names = {id(p): n for n, p in root.named_parameters()}
    return [f"params/{tree_path(root, names[id(p)])}" for p in module.parameters()]


def _tree(paths: list[str], values) -> dict:
    """A nested dict from ``/``-joined paths (the JAX package's pytree)."""
    tree: dict = {}
    for path, v in zip(paths, values):
        *parents, leaf = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


class Engine:
    """One model's training state and step."""

    def __init__(self, name: str, module: torch.nn.Module, loss_fn: LossFn, opt_cfg: dict,
                 ckpt_root: Path, ema_decay: float | None = None,
                 trainable_filter: Callable[[str], bool] | None = None):
        self.name = name
        self.module = module
        self.loss_fn = loss_fn
        self.ckpt_root = Path(ckpt_root)
        self.device = next(module.parameters()).device
        sched = opt_cfg["scheduler"]
        self.schedule = warmup_decay_schedule(sched["warmup_min_lr"], sched["warmup_max_lr"],
                                              sched["warmup_num_steps"],
                                              sched["total_num_steps"])
        self.max_norm = float(opt_cfg.get("gradient_clipping", 1.0))
        self.accum = int(opt_cfg.get("gradient_accumulation_steps", 1))
        self.names = [n for n, _ in module.named_parameters()]
        self.params = [p for _, p in module.named_parameters()]
        self.trainable = ([True] * len(self.params) if trainable_filter is None else
                          [bool(trainable_filter(path)) for path in jax_paths(module)])
        self.trained = [p for p, keep in zip(self.params, self.trainable) if keep]
        self.optimizer = torch.optim.Adam(self.trained, lr=self.schedule(0), betas=ADAM_BETAS,
                                          eps=ADAM_EPS)
        self.update_count = 0  # optimizer updates applied (optax's inner count)
        self.mini_step = 0     # micro-batches accumulated toward the next update
        self.acc = [torch.zeros_like(p) for p in self.params] if self.accum > 1 else None
        self.ema_decay = ema_decay
        self.ema = [p.detach().clone() for p in self.params] if ema_decay else None
        self.step = 0

    @property
    def global_step(self) -> int:
        return self.step

    def lr(self) -> float:
        return float(self.schedule(self.step))

    def ema_state_dict(self) -> dict[str, torch.Tensor] | None:
        """The EMA weights by parameter name (None when EMA is off)."""
        return None if self.ema is None else dict(zip(self.names, self.ema))

    @torch.no_grad()
    def _apply(self, grads):
        """Clip the trainable gradients by their global norm, then one Adam
        update at the schedule's value for the current update count."""
        grads = [g for g, keep in zip(grads, self.trainable) if keep]
        norm = global_norm(grads)
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        for p, g in zip(self.trained, grads):
            p.grad = g * factor
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.update_count)
        self.optimizer.step()
        self.update_count += 1

    def train_batch(self, batch: dict, generator: torch.Generator | None,
                    sync: bool = True) -> dict:
        """One micro-batch: loss, backward, and an optimizer update every
        ``gradient_accumulation_steps`` micro-batches.  ``sync=False`` leaves
        the stats as device scalars so the caller can fetch them later."""
        arrays = batch_to_device(batch, self.device)
        for p in self.params:
            p.grad = None
        loss, stats = self.loss_fn(self.module, arrays, generator)
        loss.backward()
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
            grad_norm = global_norm(grads)
            if self.acc is None:
                self._apply(grads)
            else:
                n = self.mini_step
                for a, g in zip(self.acc, grads):
                    a.add_((g - a) / (n + 1))
                self.mini_step = (n + 1) % self.accum
                if self.mini_step == 0:
                    self._apply([a.clone() for a in self.acc])
                    for a in self.acc:
                        a.zero_()
            for p in self.params:
                p.grad = None
            if self.ema is not None:
                d = np.float32(self.ema_decay)
                torch._foreach_mul_(self.ema, float(d))
                torch._foreach_add_(self.ema, self.params, alpha=float(np.float32(1.0) - d))
        self.step += 1
        out = {f"{self.name}.loss": loss.detach(), "lr": self.lr()}
        out.update({k: (v.detach() if isinstance(v, torch.Tensor) else v)
                    for k, v in stats.items()})
        out["grad_norm"] = grad_norm
        return _to_floats(out) if sync else out

    def diagnose(self, batch: dict, generator: torch.Generator | None, diagnostic):
        """One batch's gradients and the current parameters into a
        ``utils.diagnostic.Diagnostic``, under the JAX package's parameter
        paths and in its layouts (nothing is updated)."""
        loss, _ = self.loss_fn(self.module, batch_to_device(batch, self.device), generator)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        root = getattr(self.module, "denoiser", self.module)
        names = {id(p): n for n, p in root.named_parameters()}

        def tree(values):
            flat = torch_params_to_jax(root, {names[id(p)]: v for p, v in zip(self.params, values)})
            return _tree([f"params/{k}" for k in flat], flat.values())

        diagnostic.observe_grads(tree(grads))
        diagnostic.observe_params(tree(self.params))
        return diagnostic

    # ---------------- checkpointing ----------------

    def _ckpt_dir(self) -> Path:
        return self.ckpt_root / self.name

    def _state(self) -> dict:
        return {
            "params": self.module.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "update_count": self.update_count,
            "mini_step": self.mini_step,
            "acc": self.acc,
            "ema": self.ema,
            "step": self.step,
        }

    def save_checkpoint(self, keep: int = 3) -> Path:
        """Write ``step_<8 digits>.pt`` (via a temporary file, so a kill
        mid-save leaves no partial checkpoint) and keep the newest ``keep``."""
        d = self._ckpt_dir()
        d.mkdir(parents=True, exist_ok=True)
        path = (d / f"step_{self.step:08d}.pt").absolute()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(self._state(), tmp)
        os.replace(tmp, path)
        _logger.info(f"Saved checkpoint {path}")
        for old in sorted(d.glob("step_*.pt"))[:-keep]:
            old.unlink(missing_ok=True)
        return path

    def load_checkpoint(self, step: int | None = None) -> bool:
        """Resume from the latest checkpoint if there is one (a missing
        directory is fine), or from exactly ``step`` (then a missing
        checkpoint is an error).  Leftover temporary files of a killed save
        are removed."""
        d = self._ckpt_dir()
        if not d.exists():
            return False
        for tmp in d.glob("step_*.tmp"):
            _logger.warning(f"Removing incomplete checkpoint {tmp} (killed mid-save)")
            tmp.unlink(missing_ok=True)
        steps = sorted(d.glob("step_*.pt"))
        if step is not None:
            want = d / f"step_{step:08d}.pt"
            if want not in steps:
                have = ", ".join(p.name for p in steps) or "none"
                raise FileNotFoundError(f"restore_step={step}: {want.name} not found (have: {have})")
            path = want
        elif steps:
            path = steps[-1]
        else:
            return False
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.module.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.update_count = int(state["update_count"])
        self.mini_step = int(state["mini_step"])
        if self.acc is not None and state["acc"] is not None:
            for a, s in zip(self.acc, state["acc"]):
                a.copy_(s)
        if self.ema is not None:
            if state["ema"] is None:
                _logger.warning("Checkpoint has no EMA; seeding EMA from params")
                self.ema = [p.detach().clone() for p in self.params]
            else:
                self.ema = [e.to(self.device) for e in state["ema"]]
        self.step = int(state["step"])
        _logger.info(f"Restored checkpoint {path} (step {self.step})")
        return True


def _to_floats(stats: dict) -> dict:
    return {k: float(v) if isinstance(v, torch.Tensor) else v for k, v in stats.items()}


class Engines(dict):
    """Multi-engine step + combined stats."""

    def setup(self, cfg):
        self.cfg = cfg
        device = next(iter(self.values())).device
        self.device = device
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(getattr(cfg, "seed", 0)))
        self._pending = None  # lagged device stats when cfg.async_stats

    @property
    def global_step(self) -> int:
        return max(e.global_step for e in self.values())

    def save_checkpoint(self):
        keep = int(getattr(self.cfg, "ckpt_keep", 3) or 3)
        for e in self.values():
            e.save_checkpoint(keep=keep)

    def load_checkpoint(self):
        step = getattr(self.cfg, "restore_step", None)
        for e in self.values():
            e.load_checkpoint(step=step)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, batch: dict) -> dict:
        """One step across all engines with wall-clock timing.  With
        ``cfg.async_stats`` the stats come back one step late (no per-step
        device sync); otherwise the step ends in a device sync, so
        ``elapsed_time`` is the step's own time."""
        async_stats = getattr(self.cfg, "async_stats", False)
        t0 = time.time()
        stats: dict = {}
        for name, engine in self.items():
            stats |= self._oom_guard(
                lambda: engine.train_batch(batch, self.generator, sync=False))
            stats[f"{name}.engine_step"] = engine.global_step
        stats["global_step"] = self.global_step

        if async_stats:
            pending, self._pending = self._pending, (stats, time.time())
            if pending is None:
                return {"global_step": self.global_step, "wall_time": time.time()}
            out = self._oom_guard(lambda: _to_floats(pending[0]))
            out["elapsed_time"] = time.time() - t0
            out["wall_time"] = pending[1]
            return out

        self._oom_guard(self._sync)
        out = self._oom_guard(lambda: _to_floats(stats))
        out["elapsed_time"] = time.time() - t0
        out["wall_time"] = time.time()
        return out

    def _oom_guard(self, fn):
        """Out of device memory → checkpoint everything → re-raise."""
        try:
            return fn()
        except torch.cuda.OutOfMemoryError:
            if getattr(self.cfg, "save_on_oom", True):
                try:
                    self.save_checkpoint()
                except Exception:  # noqa: BLE001 — keep the original error
                    _logger.exception("save-on-oom checkpoint failed")
            raise

    def flush_stats(self) -> dict | None:
        """Drain the lagged stats slot after the final step (async_stats)."""
        pending, self._pending = self._pending, None
        if pending is None:
            return None
        out = self._oom_guard(lambda: _to_floats(pending[0]))
        out["wall_time"] = pending[1]
        return out
