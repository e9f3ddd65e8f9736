"""The training phases of the port's smoke run (``chip_smoke.py`` drives
them on the card at full width beside the serving phases of ``smoke.py``;
the CPU tests rehearse them at a tiny size with the plain versions).

5. train kernel — the training attention kernel against its plain version,
   forward O and dq / dk / dv, fp32 and bf16, at every attention site of a
   D3PM train step and at the AR's causal packed shape, with device times
   beside the plain version's, SDPA's and the bound;
6. train       — the train CLI's ``main`` on ``config/gen4c/diffusion.yml``
   over a seeded synthetic corpus, with the launch counts per step, the
   checkpoint and the val-loss eval checked.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from .ops import masked_attention as serve_ops
from .ops import train_flash_attention as train_ops
from .smoke import (HBM_BYTES_PER_S, PEAK_FLOPS, REPO, SMOKE_DIR, TOL, _eager_ms, _time_ms,
                    check, default_symmap, log)

REPLACES = "tts_with_diffusion_model_tpu/ops/attention.py:59"
SOURCE = "tts_with_diffusion_model_tpu_torch/csrc/train_flash_attention.cu"
TRAIN_YAML = REPO / "config" / "gen4c" / "diffusion.yml"
AR_YAML = REPO / "config" / "gen4c" / "ar.yml"


# ---------------- the corpus ----------------

def write_train_corpus(root: Path, n_speakers: int = 8, n_utts: int = 12, seed: int = 0,
                       frames=(60, 168), phones=(3, 50)) -> list[Path]:
    """A seeded synthetic training corpus in the on-disk format the loaders
    read: ``root/spk<i>/utt<j>.qnt.npy`` ((8, t) int16 codes, t uniform in
    ``frames``) and ``.phn.txt`` (space-joined phones from the built-in g2p's
    inventory, a count uniform in ``phones``).  Returns the quant paths."""
    rs = np.random.RandomState(seed)
    inventory = sorted(p for p in default_symmap() if p != "_")
    paths = []
    for i in range(n_speakers):
        d = Path(root) / f"spk{i}"
        d.mkdir(parents=True, exist_ok=True)
        for j in range(n_utts):
            n = rs.randint(frames[0], frames[1] + 1)
            np.save(d / f"utt{j}.qnt.npy", rs.randint(0, 1024, (8, n)).astype(np.int16))
            k = rs.randint(phones[0], phones[1] + 1)
            (d / f"utt{j}.phn.txt").write_text(" ".join(rs.choice(inventory, k)))
            paths.append(d / f"utt{j}.qnt.npy")
    return paths


# ---------------- 5. the training kernel against its plain version ----------------

@dataclasses.dataclass
class TrainSite:
    """One differentiated attention call site, with its forward and
    backward launches per train step."""
    name: str
    B: int
    Tq: int
    Tk: int
    H: int
    Dh: int
    causal: bool
    fwd: int
    bwd: int


def train_attention_sites(model, B: int, resp_bucket: int) -> list[TrainSite]:
    """The attentions of one sampled-t D3PM train step: each tower layer's
    self-attention, and per DiT block a self-attention over the response
    bucket and two cross-attentions (text, prompt).  With remat each block's
    three forwards run again in the backward."""
    c, den = model.config, model.denoiser
    H, Dh, L = c.n_heads, c.d_model // c.n_heads, c.n_layers
    block_fwd = L * (2 if c.remat else 1)
    nt, np_ = den.text_tower.n_layers, den.prom_tower.n_layers
    return [
        TrainSite("text tower self", B, c.text_len, c.text_len, H, Dh, False, nt, nt),
        TrainSite("prompt tower self", B, c.prom_len, c.prom_len, H, Dh, False, np_, np_),
        TrainSite("DiT self", B, resp_bucket, resp_bucket, H, Dh, False, block_fwd, L),
        TrainSite("DiT text cross", B, resp_bucket, c.text_len, H, Dh, False, block_fwd, L),
        TrainSite("DiT prompt cross", B, resp_bucket, c.prom_len, H, Dh, False, block_fwd, L),
    ]


def ar_causal_site() -> TrainSite:
    """The AR's causal packed self-attention as ``config/gen4c/ar.yml``
    shapes it (text + sep + prompt bucket + sep + response bucket, the AR
    registry width d1024 / 16 heads); not on this slice's path."""
    from .config import Config

    cfg = Config.from_cli([f"yaml={AR_YAML}"])
    T = cfg.max_text_len + 1 + max(cfg.prom_len_buckets) + 1 + max(cfg.resp_len_buckets)
    return TrainSite("AR packed causal self", cfg.batch_size, T, T, 16, 64, True, 0, 0)


def _site_inputs(s: TrainSite, dtype, device, seed):
    """q, k, v, dO and a key mask with a ragged prefix, holes and one
    all-masked row (B >= 4)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(s.B, T, s.H, s.Dh, generator=g).to(dtype).to(device)
                   for T in (s.Tq, s.Tk, s.Tk, s.Tq))
    mask = torch.ones(s.B, s.Tk)
    if s.B > 1:
        mask[1, int(torch.randint(1, s.Tk + 1, (1,), generator=g)):] = 0
    if s.B > 2:
        mask[2] = (torch.rand(s.Tk, generator=g) > 0.3).float()
        mask[2, 0] = 1
    if s.B > 3:
        mask[3] = 0
    return q, k, v, mask.to(device), do


def _fwd_bwd(fn, q, k, v, km, causal, do):
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v, km, causal)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def work(s: TrainSite, km) -> tuple[int, int]:
    """(score pairs, value pairs) this mask needs, over every head: a
    visible (query, key) pair costs a q·k and a p·v product; a row whose
    keys are all masked costs no q·k but averages all Tk values."""
    vis = train_ops.visible(km, s.Tq, s.causal)
    per_row = vis.sum(dim=-1)
    qk = int(per_row.sum())
    pv = qk + int((per_row == 0).sum()) * s.Tk
    return qk * s.H, pv * s.H


def train_bound_ms(s: TrainSite, dtype, qk: int, pv: int) -> dict:
    """Least H100 SXM time of the forward and of the backward: each input
    read once and each output written once at 3.35 TB/s, against the
    products at the type's peak.  Forward: q·kᵀ and p·v.  Backward: the
    five products of the recompute (s, dV, dP, dQ, dK), 2.5× the forward's
    on an unmasked call.  Bytes: forward q, k, v, mask → o; backward q, k,
    v, o, dO, mask → dq, dk, dv."""
    el = torch.finfo(dtype).bits // 8
    nq, nk = s.B * s.Tq * s.H * s.Dh, s.B * s.Tk * s.H * s.Dh
    mask = s.B * s.Tk * 4
    parts = {
        "fwd": ((2 * nq + 2 * nk) * el + mask, 2 * s.Dh * (qk + pv)),
        "bwd": ((4 * nq + 4 * nk) * el + mask, 2 * s.Dh * (4 * qk + pv)),
    }
    out = {}
    for name, (nbytes, flops) in parts.items():
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
        out[f"{name}_bound_ms"] = max(t_b, t_f)
        out[f"{name}_bound_by"] = "bytes" if t_b >= t_f else "operations"
        out[f"{name}_gflop"] = flops / 1e9
        out[f"{name}_mb"] = nbytes / 1e6
    return out


def _sdpa(q, k, v, km, causal):
    vis = train_ops.visible(km, q.shape[1], causal)
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=vis)
    return o.transpose(1, 2)


def check_train_site(s: TrainSite, dtype, device, seed: int, time_it: bool) -> dict:
    """The wrapper (kernel on the card) against the plain version on the same
    inputs, forward and gradients; then (``time_it``) device ms of the
    kernel's forward and backward, and of the forward and forward + backward
    of the plain version and of SDPA with a boolean key mask: calls captured
    in a CUDA graph and replayed between CUDA events (``smoke._time_ms``,
    host launch cost excluded, inputs L2-warm); and the kernel's eager wall
    ms per forward and per backward call (host cost included)."""
    fn = train_ops.train_flash_attention
    counts = (fn.launches, fn.backward_launches, fn.plain_calls)
    q, k, v, km, do = _site_inputs(s, dtype, device, seed)
    got = _fwd_bwd(fn, q, k, v, km, s.causal, do)
    ref = _fwd_bwd(train_ops.train_flash_attention_plain, q, k, v, km, s.causal, do)
    if device.type == "cuda":
        torch.cuda.synchronize()
    res = {"site": s.name, "B": s.B, "Tq": s.Tq, "Tk": s.Tk, "H": s.H, "Dh": s.Dh,
           "causal": s.causal, "dtype": str(dtype).replace("torch.", ""),
           "fwd": s.fwd, "bwd": s.bwd}
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
        check(bool(torch.isfinite(a).all()), f"{s.name} {dtype}: non-finite {name}")
        err = (a.float() - b.float()).abs().max().item()
        scale = max(1.0, b.float().abs().max().item()) if dtype == torch.bfloat16 else 1.0
        res[f"err_{name}"] = err
        check(err <= TOL[dtype] * scale,
              f"{s.name} {dtype}: {name} max abs err {err:.3g} > {TOL[dtype]:g} x {scale:.3g}")
    res["max_abs_err"] = max(res[f"err_{n}"] for n in ("o", "dq", "dk", "dv"))
    if time_it and device.type == "cuda":
        plain = train_ops.train_flash_attention_plain
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))

        def fwd(f):
            def run():
                with torch.no_grad():
                    f(q, k, v, km, s.causal)
            return run

        def both(f):
            return lambda: torch.autograd.grad(f(qg, kg, vg, km, s.causal), (qg, kg, vg), do)

        o, lse = train_ops._forward(q, k, v, km, s.causal)
        timings = {
            "ms_fwd": lambda: train_ops._forward(q, k, v, km, s.causal),
            "ms_bwd": lambda: train_ops._backward(q, k, v, km, o, lse, do, s.causal),
            "plain_ms_fwd": fwd(plain), "plain_ms_fwdbwd": both(plain),
            "library_ms_fwd": fwd(_sdpa), "library_ms_fwdbwd": both(_sdpa),
        }
        for key, f in timings.items():
            res[key] = _time_ms(f, device, iters=5, reps=3)
        res["ms_fwdbwd"] = res["ms_fwd"] + res["ms_bwd"]
        # wall ms per call of an eager loop: the host's share (ctypes, checks,
        # tensor-map encoding) beside the device time above
        res["eager_ms_fwd"] = _eager_ms(timings["ms_fwd"], device, iters=20)
        res["eager_ms_bwd"] = _eager_ms(timings["ms_bwd"], device, iters=20)
        qk, pv = work(s, km)
        res.update(train_bound_ms(s, dtype, qk, pv))
        lib_bwd = res["library_ms_fwdbwd"] - res["library_ms_fwd"]
        res["vs_library_fwd"] = res["ms_fwd"] / res["library_ms_fwd"]
        res["vs_library_bwd"] = res["ms_bwd"] / lib_bwd
        res["vs_bound_fwd"] = res["ms_fwd"] / res["fwd_bound_ms"]
        res["vs_bound_bwd"] = res["ms_bwd"] / res["bwd_bound_ms"]
    fn.launches, fn.backward_launches, fn.plain_calls = counts
    return res


def phase_train_kernel_check(device, sites: list[TrainSite], seed: int = 0) -> list[dict]:
    """Every site in fp32 and bf16; times in bf16, the training dtype."""
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    try:
        results = []
        for s in sites:
            for dtype in (torch.float32, torch.bfloat16):
                r = check_train_site(s, dtype, device, seed, time_it=dtype == torch.bfloat16)
                results.append(r)
                log(json.dumps(r))
                if "vs_library_fwd" in r:
                    log(f"ratio: train_flash_attention {r['site']} {r['Tq']}x{r['Tk']}: kernel/SDPA "
                        f"fwd {r['vs_library_fwd']:.3f} bwd {r['vs_library_bwd']:.3f}, kernel/bound "
                        f"fwd {r['vs_bound_fwd']:.2f} bwd {r['vs_bound_bwd']:.2f}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    return results


def check_backward_determinism(s: TrainSite, device, seed: int = 0) -> dict:
    """Two backward calls of the kernel on the same bf16 inputs (ragged
    masks, one all-masked row) must give bit-identical dq, dk and dv: the
    split has no atomics.  The comparison's launches are not counted."""
    fn = train_ops.train_flash_attention
    counts = (fn.launches, fn.backward_launches, fn.plain_calls)
    q, k, v, km, do = _site_inputs(s, torch.bfloat16, device, seed)
    o, lse = train_ops._forward(q, k, v, km, s.causal)
    first = train_ops._backward(q, k, v, km, o, lse, do, s.causal)
    second = train_ops._backward(q, k, v, km, o, lse, do, s.causal)
    if device.type == "cuda":
        torch.cuda.synchronize()
    same = {name: bool(torch.equal(a, b)) for name, a, b in zip(("dq", "dk", "dv"), first, second)}
    fn.launches, fn.backward_launches, fn.plain_calls = counts
    log(f"determinism: train_flash_attention backward at {s.name} (B={s.B}, {s.Tq}x{s.Tk}): "
        + ", ".join(f"{n} {'bit-identical' if ok else 'DIFFERS'}" for n, ok in same.items()))
    check(all(same.values()), f"{s.name}: two backward calls differ in {same}")
    return same


def per_step(r: dict, key: str) -> float | None:
    """A site's time in one train step: forward launches × forward time +
    backward launches × (forward-and-backward time − forward time)."""
    f, fb = r.get(f"{key}_fwd"), r.get(f"{key}_fwdbwd")
    if f is None or fb is None:
        return None
    return r["fwd"] * f + r["bwd"] * (fb - f)


def train_kernel_summary(results: list[dict], fwd: int, bwd: int, run_launches: int) -> dict:
    """The training kernel's line: per-train-step sums over the timed sites
    of the main path."""
    timed = [r for r in results if "ms_fwd" in r and (r["fwd"] or r["bwd"])]

    def total(key):
        vals = [per_step(r, key) for r in timed]
        return None if not vals or any(v is None for v in vals) else sum(vals)

    bound = {"bytes": 0.0, "operations": 0.0}
    for r in timed:
        bound[r["fwd_bound_by"]] += r["fwd"] * r["fwd_bound_ms"]
        bound[r["bwd_bound_by"]] += r["bwd"] * r["bwd_bound_ms"]
    return {
        "name": "train_flash_attention",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": fwd + bwd,
        "launches_fwd": fwd,
        "launches_bwd": bwd,
        "launches_run": run_launches,
        "max_abs_err": max(r["max_abs_err"] for r in results if r["dtype"] == "bfloat16"),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": sum(bound.values()) if timed else None,
        "bound_by": "bytes" if bound["bytes"] >= bound["operations"] else "operations",
        "library_ms": total("library_ms"),
        "per": "one D3PM train step (B=32, bucket 192, remat): sum over its attention sites "
               "of forward and backward launches x time",
    }


# ---------------- 6. the train CLI ----------------

class _Records(logging.Handler):
    """Keeps the messages of one logger (the eval lines)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def profile_train_step(engines, cfg) -> dict:
    """One more train step of the trained engines under ``torch.profiler``,
    on a batch from the run's own loader (after a warm step)."""
    from .data.dataset import create_train_val_dataloader
    from .smoke import profile_call
    from .train.train import make_bucket

    engine = engines["model"]
    train_dl, _, _ = create_train_val_dataloader(cfg, make_bucket(cfg, engine.module))
    it = iter(train_dl)
    batch = next(it)
    it.close()
    engines.step(batch)
    return profile_call(lambda: engines.step(batch), "train step")


def phase_train(device, seed: int = 0, steps: int = 8, overrides=(), corpus=None) -> dict:
    """``train.main`` on ``config/gen4c/diffusion.yml`` with its paths pointed
    into ``build/smoke/`` and ``steps`` steps, checkpoint and eval at the
    last; then the checks.  ``overrides`` (``key=value``) shrink the model
    for CPU rehearsals; ``corpus`` = (speakers, utterances, frames, phones)."""
    from .config import Config
    from .train import train as train_cli
    from .train import trainer

    data, out = SMOKE_DIR / "train_data", SMOKE_DIR / "train"
    for d in (data, out):
        shutil.rmtree(d, ignore_errors=True)
    n_spk, n_utt, frames, phones = corpus or (8, 12, (60, 168), (3, 50))
    write_train_corpus(data, n_spk, n_utt, seed, frames, phones)
    argv = [f"yaml={TRAIN_YAML}", f"data_dirs=[{data}]", f"log_root={out / 'logs'}",
            f"ckpt_root={out / 'ckpts'}", f"max_iter={steps}", f"eval_every={steps}",
            f"save_ckpt_every={steps}", *overrides]
    cfg = Config.from_cli(argv)
    log(f"train: {' '.join(argv[1:])}")

    fn, serve = train_ops.train_flash_attention, serve_ops.masked_attention
    records = []

    def step_logger(data):
        trainer.logger(data)
        records.append((data, fn.launches, fn.backward_launches, fn.plain_calls))

    evals = _Records()
    train_logger = logging.getLogger(train_cli.__name__)
    train_logger.addHandler(evals)
    fn.launches = fn.backward_launches = fn.plain_calls = 0
    serve.launches = serve.plain_calls = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        engines = train_cli.main(cfg, logger=step_logger)
    finally:
        train_logger.removeHandler(evals)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    serve_launches, serve_plain = serve.launches, serve.plain_calls
    engine = engines["model"]

    # launches per step against the count derived from the model's config
    bucket = min(b for b in cfg.resp_len_buckets)
    sites = train_attention_sites(engine.module, cfg.batch_size, bucket)
    want_fwd, want_bwd = sum(s.fwd for s in sites), sum(s.bwd for s in sites)
    check(len(records) == steps, f"{len(records)} logged steps != {steps}")
    prev = (0, 0, 0)
    per_step_counts = []
    for i, (stats, f, b, p) in enumerate(records):
        check(stats["global_step"] == i + 1, f"step {i + 1} logged as {stats['global_step']}")
        for key in ("model.loss", "grad_norm"):
            check(math.isfinite(stats[key]), f"step {i + 1}: {key} = {stats[key]}")
        per_step_counts.append((f - prev[0], b - prev[1], p - prev[2]))
        prev = (f, b, p)
    if device.type == "cuda":
        check(all(c == (want_fwd, want_bwd, 0) for c in per_step_counts),
              f"kernel launches per step {per_step_counts} != ({want_fwd}, {want_bwd}, 0)")
        check(serve_plain == 0, "the plain path ran on the card")
    else:  # the plain version stands in for every forward, remat included
        check(all(c[2] == want_fwd for c in per_step_counts),
              f"plain calls per step {[c[2] for c in per_step_counts]} != {want_fwd}")

    # the val-loss eval ran, under no_grad, through the serving kernel
    eval_lines = [ln for ln in evals.lines if ln.startswith("Eval:")]
    check(len(eval_lines) == 2, f"{len(eval_lines)} eval lines != 2 (subtrain, val)")
    den = engine.module.denoiser
    per_eval_batch = den.text_tower.n_layers + den.prom_tower.n_layers + 3 * den.n_layers
    served = serve_launches if device.type == "cuda" else serve_plain
    check(served > 0 and served % per_eval_batch == 0,
          f"eval attention calls {served} are not a positive multiple of {per_eval_batch}")

    # the weights moved, and the checkpoint reloads into a fresh engine
    init = train_cli.build_model(cfg, device)
    train_cli.init_params(cfg, init)
    moved = max((a - b).abs().max().item() for a, b in
                zip(engine.module.parameters(), init.parameters()))
    ema_moved = max((a - b).abs().max().item() for a, b in zip(engine.ema, init.parameters()))
    check(moved > 0 and ema_moved > 0, f"params moved {moved}, EMA moved {ema_moved}")
    ckpt = cfg.ckpt_dir / "model" / f"step_{steps:08d}.pt"
    check(ckpt.exists(), f"no checkpoint at {ckpt}")
    fresh = train_cli.load_engines(cfg)["model"]
    check(fresh.step == steps, f"reloaded step {fresh.step} != {steps}")
    same = all(torch.equal(a, b) for a, b in zip(fresh.params + fresh.ema,
                                                 engine.params + engine.ema))
    opt_a, opt_b = fresh.optimizer.state_dict()["state"], engine.optimizer.state_dict()["state"]
    same = same and all(torch.equal(opt_a[i][k].cpu(), opt_b[i][k].cpu())
                        for i in opt_b for k in opt_b[i])
    check(same, "the reloaded engine differs from the trained one")

    times = [r[0]["elapsed_time"] for r in records]
    p50 = float(np.median(times[1:] if len(times) > 1 else times))
    frames = cfg.batch_size * bucket
    out_d = {"engines": engines, "cfg": cfg, "steps": steps, "wall_s": wall, "step_s": times, "p50_step_s": p50,
             "frames_per_s": frames / p50, "peak_bytes": peak, "fwd_per_step": want_fwd,
             "bwd_per_step": want_bwd, "run_launches": prev[0] + prev[1],
             "eval_launches": serve_launches, "eval": eval_lines, "moved": moved,
             "ema_moved": ema_moved, "losses": [r[0]["model.loss"] for r in records],
             "sites": sites, "checkpoint": str(ckpt)}
    where = "host clock around synchronised steps" if device.type == "cuda" else "cpu"
    log(f"train: {steps} steps in {wall:.1f} s; step p50 {p50 * 1e3:.1f} ms ({where}), first "
        f"{times[0] * 1e3:.1f} ms; {out_d['frames_per_s']:.0f} padded frames/s "
        f"(B={cfg.batch_size} x bucket {bucket}); peak allocated "
        f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    log(f"train: kernel launches per step {per_step_counts[0]} (fwd, bwd, plain) = "
        f"{want_fwd} fwd + {want_bwd} bwd derived from the config; eval launches "
        f"{serve_launches}; losses {[round(x, 4) for x in out_d['losses']]}")
    return out_d
