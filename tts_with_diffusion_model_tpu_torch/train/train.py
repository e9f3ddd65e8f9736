"""Training entry point: ``python -m tts_with_diffusion_model_tpu_torch.train
yaml=<cfg> [key=value ...]`` (counterpart of ``train/train.py`` in the JAX
package).

Builds the model from ``cfg.model`` (``diffusion*``, ``ar*``, ``nar*``),
wraps its loss feeder in an ``Engine`` on ``cfg.device`` (the card unless
``device=cpu``), resumes from the latest checkpoint, and hands everything to
the generic loop.  Eval computes the val loss under ``no_grad`` through the
same feeder with a generator seeded from 0, so the AR's and NAR's eval
runs with dropout on, as the JAX package's does.  On the card a
non-causal eval attention runs the serving kernel and a causal one the
training kernel's forward (``ops/route.py``).

Not ported yet, and rejected by name rather than ignored:
``eval_decode_audio``, ``profile_every``, ``zero1``, a mesh larger than
1×1, ``cache_dataloader`` and ``gradient_checkpointing_policy: dots``.
"""

from __future__ import annotations

import contextlib
import logging

import torch

from ..config import Config
from ..convert import init_seeded
from ..data.dataset import BucketSpec, create_train_val_dataloader
from ..models import get_model
from ..utils.device import resolve_device
from ..utils.logging import setup_logging
from . import trainer
from .engine import Engine, batch_to_device

_logger = logging.getLogger(__name__)


def check_supported(cfg: Config) -> None:
    """Raise on a knob whose code the port does not have yet."""
    unported = {
        "eval_decode_audio": cfg.eval_decode_audio,
        "profile_every": cfg.profile_every,
        "zero1": cfg.zero1,
        "cache_dataloader": cfg.cache_dataloader,
    }
    for name, value in unported.items():
        if value:
            raise NotImplementedError(f"{name}={value!r} is not ported yet (ROADMAP queue 1, "
                                      "\"what is left of training\"); the port trains on one "
                                      "card without it")
    if cfg.mesh_dp not in (-1, 1) or cfg.mesh_tp != 1:
        raise NotImplementedError(
            f"mesh_dp={cfg.mesh_dp} mesh_tp={cfg.mesh_tp} is not ported yet (ROADMAP queue 1, "
            "\"parallel/mesh.py, parallel/infer.py\"); the port trains on a 1x1 mesh")


def build_model(cfg: Config, device=None):
    """Model from cfg with the training knobs threaded in
    (``diffusion_train_mode``, ``gradient_checkpointing`` → remat,
    ``gradient_checkpointing_policy``, ``attn_impl``) and ``use_fp16`` →
    bf16 compute, else fp32.  Explicit ``model_overrides`` win.  Parameters
    are fp32 on ``device`` (uninitialised: see ``init_params``)."""
    overrides = dict(cfg.model_overrides or {})
    if cfg.model.startswith("diffusion"):
        overrides.setdefault("train_mode", cfg.diffusion_train_mode)
    overrides.setdefault("remat", cfg.gradient_checkpointing)
    overrides.setdefault("remat_policy", cfg.gradient_checkpointing_policy)
    if cfg.attn_impl is not None:
        overrides.setdefault("attn_impl", cfg.attn_impl)
    dtype = torch.bfloat16 if cfg.use_fp16 else torch.float32
    model = get_model(cfg.model, cfg.num_tokens, overrides, dtype=dtype)
    return model if device is None else model.to(device)


def make_bucket(cfg: Config, model) -> BucketSpec:
    c = getattr(model, "config", None)
    if c is not None and hasattr(c, "resp_len"):  # diffusion family models
        return BucketSpec(c.text_len, c.prom_len, c.resp_len)
    return BucketSpec(cfg.max_text_len, cfg.max_prom_len, cfg.max_resp_len)


def make_loss_fn(cfg: Config, model):
    """The per-family loss feeder ``loss_fn(module, batch, generator)`` →
    (loss, stats).  The generator drives every draw of the step: the
    diffusion timesteps and corruption (``max_train_diffusion_steps`` caps
    t), the NAR's levels (uniform in [0, 7) per row) and the AR's and NAR's
    dropout."""
    name = cfg.model.lower()
    if name.startswith("diffusion"):
        max_t = cfg.max_train_diffusion_steps
        if max_t is not None:
            max_t = min(max_t, model.config.timesteps)

        def loss_fn(module, batch, generator):
            return module.loss(batch, generator, max_t=max_t)

        return loss_fn

    if name.startswith("ar"):

        def loss_fn(module, batch, generator):
            _, losses = module(batch["text"], batch["text_mask"], batch["proms"],
                               batch["prom_mask"], batch["resp"], batch["resp_mask"],
                               generator=generator)
            return sum(losses.values()), losses

        return loss_fn

    if name.startswith("nar"):

        def loss_fn(module, batch, generator):
            B = batch["text"].shape[0]
            quant_levels = torch.randint(0, 7, (B,), generator=generator,
                                         device=batch["text"].device)
            _, losses = module(batch["text"], batch["text_mask"], batch["proms"],
                               batch["prom_mask"], batch["resps"], batch["resp_mask"],
                               quant_levels, generator=generator)
            return sum(losses.values()), losses

        return loss_fn

    raise NotImplementedError(name)


def init_params(cfg: Config, model) -> None:
    """Seeded weights from ``cfg.seed`` (drawn on the CPU, so the same on
    every device): the diffusion family's denoiser, or the whole AR / NAR."""
    init_seeded(getattr(model, "denoiser", model), cfg.seed)


def load_engines(cfg: Config | None = None, model=None):
    """model → seeded init → Engine → resume from the latest checkpoint."""
    if cfg is None:
        cfg = Config.from_cli()
    device = resolve_device(cfg.device)
    if model is None:
        model = build_model(cfg, device)
        init_params(cfg, model)
    clip = cfg.max_grad_norm if cfg.max_grad_norm is not None else cfg.gradient_clipping
    opt_cfg = dict(cfg.optimizer_cfg)
    opt_cfg["gradient_clipping"] = clip
    opt_cfg["gradient_accumulation_steps"] = cfg.gradient_accumulation_steps
    engines = dict(model=Engine(name="model", module=model, loss_fn=make_loss_fn(cfg, model),
                                opt_cfg=opt_cfg, ckpt_root=cfg.ckpt_dir,
                                ema_decay=cfg.ema_decay))
    return trainer.load_engines(engines, cfg)


class _EmaWeights:
    """Swap a module's parameters for the engine's EMA copy inside a
    ``with`` block (values only: the parameters' dtype and device stay)."""

    def __init__(self, engine: Engine):
        self.engine = engine

    def __enter__(self):
        self.saved = [p.detach().clone() for p in self.engine.params]
        with torch.no_grad():
            for p, e in zip(self.engine.params, self.engine.ema):
                p.copy_(e)

    def __exit__(self, *exc):
        with torch.no_grad():
            for p, s in zip(self.engine.params, self.saved):
                p.copy_(s)
        return False


def main(cfg: Config | None = None, logger=None):
    """Train until ``max_iter`` or ``quit``; returns the engines.  ``logger``
    replaces the JSON-line stats logger (it gets ``data=stats``)."""
    if cfg is None:
        cfg = Config.from_cli()
    check_supported(cfg)
    device = resolve_device(cfg.device)
    setup_logging(cfg.log_dir)

    model = build_model(cfg, device)
    init_params(cfg, model)
    bucket = make_bucket(cfg, model)
    train_dl, subtrain_dl, val_dl = create_train_val_dataloader(cfg, bucket)
    loss_fn = make_loss_fn(cfg, model)

    @torch.no_grad()
    def run_eval(engines, name, dl):
        """Val loss, averaged over ``dl``'s batches, with a generator seeded
        from 0 (the JAX package evaluates with PRNGKey(0))."""
        engine = engines["model"]
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
        use_ema = cfg.eval_use_ema and engine.ema is not None
        losses = []
        with _EmaWeights(engine) if use_ema else contextlib.nullcontext():
            for batch in dl:
                loss, _ = loss_fn(engine.module, batch_to_device(batch, device), generator)
                losses.append(float(loss))
        if losses:
            stats = {"loss": sum(losses) / len(losses), "global_step": engines.global_step,
                     "name": name}
            _logger.info(f"Eval: {stats}.")
        return 0

    def eval_fn(engines):
        run_eval(engines, "subtrain", subtrain_dl)
        run_eval(engines, "val", val_dl)

    kw = {} if logger is None else {"logger": logger}
    return trainer.train(engines_loader=lambda: load_engines(cfg, model), train_dl=train_dl,
                         eval_fn=eval_fn, **kw)


if __name__ == "__main__":
    main()
