"""Training entry point: ``python -m tts_with_diffusion_model_tpu_torch.train
yaml=<cfg> [key=value ...]`` (counterpart of ``train/train.py`` in the JAX
package).

Builds the model from ``cfg.model`` (``diffusion*``, ``diffusion-gaussian*``,
``ar*``, ``nar*``),
wraps its loss feeder in an ``Engine`` on ``cfg.device`` (the card unless
``device=cpu``), resumes from the latest checkpoint, and hands everything to
the generic loop.  Eval computes the val loss under ``no_grad`` through the
same feeder with a generator seeded from 0, so the AR's and NAR's eval
runs with dropout on, as the JAX package's does.  With
``eval_decode_audio`` it then generates for the eval's first batch (the
AR's ``ar_generate``, the NAR given level 0, the D3PM's ancestral chain, the
Gaussian model's T-step chain), decodes hypotheses and references with the codec, and
writes ``hyp/`` and ``ref/`` wavs and ``metrics.json`` (token accuracy per
level, DTW mel-cepstral distortion) under ``log_dir/<step>/<name>/``.  On
the card a non-causal eval attention runs the serving kernel and a causal
one the training kernel's forward (``ops/route.py``).

Not ported yet, and rejected by name rather than ignored: ``zero1`` and a
mesh larger than 1×1.
"""

from __future__ import annotations

import contextlib
import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..audio.wavio import write_wav
from ..codec import encodec
from ..config import Config
from ..convert import init_seeded
from ..data.dataset import BucketSpec, create_train_val_dataloader
from ..models import get_model
from ..models.ar import ar_generate
from ..models.nar import nar_generate
from ..utils.device import resolve_device
from ..utils.logging import setup_logging
from ..utils.metrics import aggregate_metrics, eval_utterance_metrics
from ..utils.rng import RowKeys
from . import trainer
from .engine import Engine, batch_to_device

_logger = logging.getLogger(__name__)


def check_supported(cfg: Config) -> None:
    """Raise on a knob whose code the port does not have yet."""
    if cfg.zero1:
        raise NotImplementedError(
            "zero1=True is not ported yet (ROADMAP queue 1, \"parallel/mesh.py, "
            "parallel/infer.py\"); the port trains on one card without it")
    check_mesh(cfg)


def check_mesh(cfg: Config) -> None:
    """Raise on a mesh larger than 1×1 (not ported yet)."""
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
    diffusion timesteps and corruption or noise (``max_train_diffusion_steps``
    caps t, for the D3PM and the Gaussian family: its val loss is the MSE), the NAR's levels (uniform in [0, 7) per row) and the AR's and NAR's
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


def eval_params(cfg: Config, engine: Engine):
    """The weights eval runs with, as a context: the EMA average when
    ``eval_use_ema`` is set and tracked, else the raw parameters."""
    return (_EmaWeights(engine) if cfg.eval_use_ema and engine.ema is not None
            else contextlib.nullcontext())


def decode_rows(rows: list[np.ndarray], codec) -> tuple[list[np.ndarray], int]:
    """Decode a list of (t_i, q) code arrays in one codec call: every row
    padded to the longest rounded up to 64 frames with its last frame
    repeated (edge-replicated codes, so the decoder sees signal-like
    context rather than a cliff), each wav cut back to t_i·HOP samples."""
    lens = [len(r) for r in rows]
    T = -(-max(lens) // 64) * 64
    padded = np.stack([np.concatenate([r, np.repeat(r[-1:], T - len(r), axis=0)], axis=0)
                       for r in rows])  # (B, T, q)
    wavs, sr = codec.decode(np.moveaxis(padded, 1, 2))
    return [wavs[i, : lens[i] * encodec.HOP] for i in range(len(rows))], sr


@torch.no_grad()
def generate_codes(cfg: Config, module, batch: dict, step: int) -> list[np.ndarray]:
    """The eval batch's hypotheses, each (t_i, q) codes over the reference's
    span: the AR's tokens up to its stop (``max_val_ar_steps``), the NAR's
    eight levels given level 0, the diffusion model's ancestral chain (stride
    1), or the Gaussian model's chain over every process step, cut to the
    reference's length.  Row i draws from ``RowKeys`` of seed
    i folded with ``step``."""
    dev = next(module.parameters()).device
    arrays = batch_to_device(batch, dev)
    args = (arrays["text"], arrays["text_mask"], arrays["proms"], arrays["prom_mask"])
    n_rows = arrays["text"].shape[0]
    keys = RowKeys.from_seeds(range(n_rows)).fold(step)
    lens = batch["resp_mask"].sum(axis=1).astype(int)
    name = cfg.model.lower()
    if name.startswith("ar"):
        toks, n = ar_generate(module, *args, keys, max_steps=cfg.max_val_ar_steps,
                              sampling_temperature=cfg.sampling_temperature)
        toks, n = toks.cpu().numpy(), n.cpu().numpy()
        return [toks[i, : int(n[i])][:, None] for i in range(n_rows)]
    if name.startswith("nar"):
        out = nar_generate(module, *args, arrays["resp"], arrays["resp_mask"], keys,
                           sampling_temperature=cfg.sampling_temperature).cpu().numpy()
        return [out[i, : lens[i]] for i in range(n_rows)]
    # the diffusion family generates a fixed window: score the reference's span
    out = module.generate(*args, keys).cpu().numpy()
    return [out[i, : lens[i], None] for i in range(n_rows)]


def decode_eval_audio(cfg: Config, engines, name: str, batch: dict, codec) -> dict:
    """Hypothesis and reference wavs and their metrics under
    ``log_dir/<step>/<name>/{hyp,ref}``, and ``metrics.json`` (the mean and
    each utterance's); returns the mean."""
    step, engine = engines.global_step, engines["model"]
    out_root = Path(cfg.log_dir) / str(step) / name
    with eval_params(cfg, engine):
        hyps = generate_codes(cfg, engine.module, batch, step)
    # the NAR is given level 0: it is reported as teacher-provided, not scored
    teacher_levels = 1 if cfg.model.lower().startswith("nar") else 0
    refs = [np.asarray(batch["resps"][i][: int(batch["resp_mask"][i].sum())])
            for i in range(len(batch["path"]))]
    ref_wavs, sr = decode_rows(refs, codec)
    nonempty = [i for i, h in enumerate(hyps) if len(h) > 0]
    hyp_wavs = {}
    if nonempty:
        ws, _ = decode_rows([hyps[i] for i in nonempty], codec)
        hyp_wavs = dict(zip(nonempty, ws))
    per_utt = []
    for i, path in enumerate(batch["path"]):
        rel = Path(path).name.split(".")[0]
        for d in ("hyp", "ref"):
            (out_root / d).mkdir(parents=True, exist_ok=True)
        write_wav(out_root / "ref" / f"{rel}.wav", ref_wavs[i], sr)
        if i in hyp_wavs:
            write_wav(out_root / "hyp" / f"{rel}.wav", hyp_wavs[i], sr)
            per_utt.append(eval_utterance_metrics(hyps[i], refs[i], hyp_wavs[i], ref_wavs[i], sr,
                                                  teacher_levels=teacher_levels))
        else:
            per_utt.append({"len_ratio": 0.0, "acc": 0.0})
    metrics = aggregate_metrics(per_utt)
    metrics.update({"global_step": step, "name": name})
    _logger.info(f"Eval metrics: {json.dumps(metrics)}.")
    with open(out_root / "metrics.json", "w") as f:
        json.dump({"mean": metrics, "per_utt": per_utt}, f, indent=1)
    return metrics


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
    codec = None

    @torch.no_grad()
    def run_eval(engines, name, dl):
        """Val loss, averaged over ``dl``'s batches, with a generator seeded
        from 0 (the JAX package evaluates with PRNGKey(0)); then, with
        ``eval_decode_audio``, the first batch's wavs and metrics."""
        nonlocal codec
        engine = engines["model"]
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
        losses, first_batch = [], None
        with eval_params(cfg, engine):
            for batch in dl:
                loss, _ = loss_fn(engine.module, batch_to_device(batch, device), generator)
                losses.append(float(loss))
                if first_batch is None:
                    first_batch = batch
        if losses:
            stats = {"loss": sum(losses) / len(losses), "global_step": engines.global_step,
                     "name": name}
            _logger.info(f"Eval: {stats}.")
        if cfg.eval_decode_audio and first_batch is not None:
            if codec is None:
                codec = encodec.load_codec(encodec.find_weights(), device)
            decode_eval_audio(cfg, engines, name, first_batch, codec)
        return 0

    def eval_fn(engines):
        run_eval(engines, "subtrain", subtrain_dl)
        run_eval(engines, "val", val_dl)

    kw = {} if logger is None else {"logger": logger}
    try:
        return trainer.train(engines_loader=lambda: load_engines(cfg, model),
                             train_dl=train_dl, eval_fn=eval_fn, **kw)
    finally:
        close = getattr(train_dl, "close", None)
        if close is not None:
            close()


if __name__ == "__main__":
    main()
