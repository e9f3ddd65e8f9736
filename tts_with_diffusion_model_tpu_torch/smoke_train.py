"""The training phases of the port's smoke run (``chip_smoke.py`` drives
them on the card at full width beside the serving phases of ``smoke.py``;
the CPU tests rehearse them at a tiny size with the plain versions).

5. train kernel — the training attention kernel against its plain version,
   forward O and dq / dk / dv, fp32 and bf16, at every attention site of a
   train step of the gen4c recipes (the D3PM's five sites, the NAR's and
   the AR's packed self-attention, ar-quarter's) and of the AR's val-loss
   eval, with device times beside the plain version's, SDPA's and the
   bound;
6. train       — the train CLI's ``main`` on a recipe
   (``config/gen4c/{diffusion,nar,ar}.yml``, or gen4b's) over a seeded
   synthetic corpus, with the loader it took, the launch counts per step,
   the checkpoint, the val-loss eval and (``eval_decode_audio``) each eval
   decode's launches and seconds checked or recorded.
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

from .data import dataset
from .ops import masked_attention as serve_ops
from .ops import train_flash_attention as train_ops
from .smoke import (HBM_BYTES_PER_S, PEAK_FLOPS, REPO, SMOKE_DIR, TOL, _eager_ms, _time_ms,
                    check, check_route, default_symmap, full_fp32, log, work)

REPLACES = "tts_with_diffusion_model_tpu/ops/attention.py:59"
SOURCE = "tts_with_diffusion_model_tpu_torch/csrc/train_flash_attention.cu"
TRAIN_YAML = REPO / "config" / "gen4c" / "diffusion.yml"
NAR_YAML = REPO / "config" / "gen4c" / "nar.yml"
AR_YAML = REPO / "config" / "gen4c" / "ar.yml"
AR_QUARTER_YAML = REPO / "config" / "gen4c" / "ar_quarter.yml"


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
    """One attention call site of the training kernel, with its forward and
    backward launches per train step of ``path`` (the recipe it belongs
    to); ``fused``: q, k and v are strided views of one (B, T, 3, H, Dh)
    projection, as the AR and NAR make them."""
    name: str
    B: int
    Tq: int
    Tk: int
    H: int
    Dh: int
    causal: bool
    fwd: int
    bwd: int
    path: str = "d3pm"
    fused: bool = False
    #: (text bucket, prompt bucket): the key mask of the AR prefill's packed
    #: layout (text pads and prompt pads mid-row, both seps valid) instead of
    #: ragged prefixes, holes and an all-masked row
    layout: tuple[int, int] | None = None


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


def recipe(yaml: Path):
    """A recipe's config and its model, the model's parameters on the meta
    device (shapes only, nothing allocated)."""
    from .config import Config
    from .train.train import build_model

    cfg = Config.from_cli([f"yaml={yaml}"])
    with torch.device("meta"):
        return cfg, build_model(cfg)


def packed_len(cfg, eval_bucket: bool = False) -> int:
    """Slots of the AR/NAR packed layout: text + sep + prompt + sep +
    response.  Training batches take the largest length buckets; the eval
    loaders pad to the ``max_*_len`` bucket."""
    if eval_bucket:
        return cfg.max_text_len + 1 + cfg.max_prom_len + 1 + cfg.max_resp_len
    return cfg.max_text_len + 1 + max(cfg.prom_len_buckets) + 1 + max(cfg.resp_len_buckets)


def packed_attention_sites(model, cfg, name: str, path: str) -> list[TrainSite]:
    """The AR's or NAR's one attention site per block: the packed
    self-attention (causal for the AR), 2 × n_layers forwards per step with
    remat and n_layers backwards."""
    base = model.base
    attn = base.blocks()[0].attn
    L, T = base.n_layers, packed_len(cfg)
    return [TrainSite(name, cfg.batch_size, T, T, attn.n_heads, attn.d_model // attn.n_heads,
                      attn.causal, L * (2 if base.remat else 1), L, path=path, fused=True)]


def step_sites(model, cfg) -> list[TrainSite]:
    """The training kernel's sites in one train step of ``model``."""
    if cfg.model.startswith("diffusion-gaussian"):
        from .smoke_gaussian import path_name, train_sites

        return train_sites(model, cfg.batch_size, min(cfg.resp_len_buckets),
                           path_name(cfg.model))
    if hasattr(model, "denoiser"):
        return train_attention_sites(model, cfg.batch_size, min(cfg.resp_len_buckets))
    family = "ar" if model.base.blocks()[0].attn.causal else "nar"
    name = "AR packed causal self" if family == "ar" else "NAR packed self"
    return packed_attention_sites(model, cfg, name, family)


def eval_attentions(model) -> tuple[str, int]:
    """Which kernel the val-loss eval (under ``no_grad``) runs, and its
    launches per eval batch: the serving kernel for non-causal attention,
    the training kernel's forward for the AR's causal one."""
    from .models.gaussian_tts import GaussianDiffusionModel

    if isinstance(model, GaussianDiffusionModel):
        from .smoke_gaussian import eval_launches

        return "masked_attention", eval_launches(model)
    if hasattr(model, "denoiser"):
        den = model.denoiser
        return "masked_attention", den.text_tower.n_layers + den.prom_tower.n_layers + 3 * den.n_layers
    base = model.base
    causal = base.blocks()[0].attn.causal
    return ("train_flash_attention" if causal else "masked_attention"), base.n_layers


def nar_eval_site() -> tuple[int, "Site"]:
    """(B, site) of the serving kernel in the NAR's val-loss eval: the
    packed self-attention at the eval loader's bucket, B =
    ``eval_batch_size``, one launch per block per eval batch."""
    from .smoke import Site

    cfg, model = recipe(NAR_YAML)
    attn = model.base.blocks()[0].attn
    T = packed_len(cfg, eval_bucket=True)
    return cfg.eval_batch_size, Site("NAR eval self", T, T, attn.n_heads,
                                     attn.d_model // attn.n_heads, model.base.n_layers)


def ar_causal_site() -> TrainSite:
    """The AR's causal packed self-attention as ``config/gen4c/ar.yml``
    shapes it (text + sep + prompt bucket + sep + response bucket)."""
    cfg, model = recipe(AR_YAML)
    return step_sites(model, cfg)[0]


def packed_sites() -> list[TrainSite]:
    """The training kernel's sites of the NAR and AR recipes: their train
    steps, ar-quarter's (a recipe ``chip_smoke.py`` does not run), and the
    AR's val-loss eval forward at the eval loader's bucket (B =
    ``eval_batch_size``; path "ar eval", whose step is one eval batch)."""
    nar_cfg, nar = recipe(NAR_YAML)
    ar_cfg, ar = recipe(AR_YAML)
    q_cfg, quarter = recipe(AR_QUARTER_YAML)
    ar_site = step_sites(ar, ar_cfg)[0]
    T = packed_len(ar_cfg, eval_bucket=True)
    return [*step_sites(nar, nar_cfg), ar_site,
            *packed_attention_sites(quarter, q_cfg, "ar-quarter packed causal self",
                                    "ar-quarter"),
            dataclasses.replace(ar_site, name="AR eval causal self", B=ar_cfg.eval_batch_size,
                                Tq=T, Tk=T, fwd=eval_attentions(ar)[1], bwd=0, path="ar eval")]


def _site_inputs(s: TrainSite, dtype, device, seed):
    """q, k, v, dO and a key mask with a ragged prefix, holes and one
    all-masked row (B >= 4); q, k, v views of one fused tensor when
    ``s.fused``."""
    g = torch.Generator().manual_seed(seed)
    if s.fused:
        qkv = torch.randn(s.B, s.Tq, 3, s.H, s.Dh, generator=g).to(dtype).to(device)
        q, k, v = qkv.unbind(2)
        do = torch.randn(s.B, s.Tq, s.H, s.Dh, generator=g).to(dtype).to(device)
    else:
        q, k, v, do = (torch.randn(s.B, T, s.H, s.Dh, generator=g).to(dtype).to(device)
                       for T in (s.Tq, s.Tk, s.Tk, s.Tq))
    if s.layout is not None:
        return q, k, v, prefix_mask(s.B, *s.layout, g).to(device), do
    mask = torch.ones(s.B, s.Tk)
    if s.B > 1:
        mask[1, int(torch.randint(1, s.Tk + 1, (1,), generator=g)):] = 0
    if s.B > 2:
        mask[2] = (torch.rand(s.Tk, generator=g) > 0.3).float()
        mask[2, 0] = 1
    if s.B > 3:
        mask[3] = 0
    return q, k, v, mask.to(device), do


def prefix_mask(B: int, text_len: int, prompt_bucket: int, g) -> torch.Tensor:
    """(B, text + 1 + prompt + 1) key mask of AR prefills: each row's valid
    phones and prompt frames (at least 3 and 1) then pads, both seps valid."""
    rows = []
    for _ in range(B):
        nt = int(torch.randint(3, text_len + 1, (1,), generator=g))
        n_p = int(torch.randint(1, prompt_bucket + 1, (1,), generator=g))
        rows.append(torch.cat([(torch.arange(text_len) < nt).float(), torch.ones(1),
                               (torch.arange(prompt_bucket) < n_p).float(), torch.ones(1)]))
    return torch.stack(rows)


def ar_prefill_sites(prompt_buckets, timed_bucket: int, text_len: int = 50, B: int = 4,
                     layers: int = 12) -> list[TrainSite]:
    """Kernel 2's forward at the AR serving prefill (causal, forward only):
    the registry ``ar`` (16 heads of 64) at each prompt bucket, one launch
    per block per batch at ``timed_bucket`` (path "ar serve"), and the
    ``ar-quarter`` draft's (4 heads of 64) at ``timed_bucket`` (path "ar
    serve draft", run by speculative serving only)."""
    sites = []
    for pb in prompt_buckets:
        T = text_len + 1 + pb + 1
        fwd = layers if pb == timed_bucket else 0
        sites.append(TrainSite("AR prefill causal self", B, T, T, 16, 64, True, fwd, 0,
                               path="ar serve", fused=True, layout=(text_len, pb)))
    T = text_len + 1 + timed_bucket + 1
    sites.append(TrainSite("ar-quarter prefill causal self", B, T, T, 4, 64, True, layers, 0,
                           path="ar serve draft", fused=True, layout=(text_len, timed_bucket)))
    return sites


def _fwd_bwd(fn, q, k, v, km, causal, do):
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v, km, causal)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


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


def _counters(fn) -> tuple[int, ...]:
    return (fn.launches, fn.launches_tc, fn.backward_launches, fn.backward_launches_tc,
            fn.plain_calls)


def _restore(fn, counts):
    (fn.launches, fn.launches_tc, fn.backward_launches, fn.backward_launches_tc,
     fn.plain_calls) = counts


def check_train_site(s: TrainSite, dtype, device, seed: int, time_it: bool) -> dict:
    """The wrapper (kernel on the card) against the plain version on the same
    inputs, forward and gradients, the routes of its forward and backward
    held to ``route.tensor_core_route``; then (``time_it``) device ms of the
    kernel's forward and backward, and of the forward and forward + backward
    of the plain version and of SDPA with a boolean key mask: calls captured
    in a CUDA graph and replayed between CUDA events (``smoke._time_ms``,
    host launch cost excluded, inputs L2-warm); and the kernel's eager wall
    ms per forward and per backward call (host cost included)."""
    fn = train_ops.train_flash_attention
    counts = _counters(fn)
    q, k, v, km, do = _site_inputs(s, dtype, device, seed)
    got = _fwd_bwd(fn, q, k, v, km, s.causal, do)
    tc = (fn.launches_tc - counts[1], fn.backward_launches_tc - counts[3])
    ref = _fwd_bwd(train_ops.train_flash_attention_plain, q, k, v, km, s.causal, do)
    if device.type == "cuda":
        torch.cuda.synchronize()
    res = {"site": s.name, "B": s.B, "Tq": s.Tq, "Tk": s.Tk, "H": s.H, "Dh": s.Dh,
           "causal": s.causal, "dtype": str(dtype).replace("torch.", ""),
           "fwd": s.fwd, "bwd": s.bwd, "path": s.path, "fused": s.fused}
    if device.type == "cuda":
        o = got[0]
        res["route"] = check_route(f"train_flash_attention {s.name} {dtype} forward", tc[0],
                                   s.Dh, dtype, (q, k, v, o))
        res["route_bwd"] = check_route(f"train_flash_attention {s.name} {dtype} backward",
                                       tc[1], s.Dh, dtype, (q, k, v, o, do))
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
        qk, pv = work(km, s.Tq, s.H, s.causal)
        res.update(train_bound_ms(s, dtype, qk, pv))
        lib_bwd = res["library_ms_fwdbwd"] - res["library_ms_fwd"]
        res["vs_library_fwd"] = res["ms_fwd"] / res["library_ms_fwd"]
        res["vs_library_bwd"] = res["ms_bwd"] / lib_bwd
        res["vs_bound_fwd"] = res["ms_fwd"] / res["fwd_bound_ms"]
        res["vs_bound_bwd"] = res["ms_bwd"] / res["bwd_bound_ms"]
    _restore(fn, counts)
    return res


def phase_train_kernel_check(device, sites: list[TrainSite], seed: int = 0) -> list[dict]:
    """Every site in fp32 and bf16; times in bf16, the training dtype, at
    the sites a path launches."""
    with full_fp32():
        results = []
        for s in sites:
            for dtype in (torch.float32, torch.bfloat16):
                timed = dtype == torch.bfloat16 and bool(s.fwd or s.bwd)
                r = check_train_site(s, dtype, device, seed, time_it=timed)
                results.append(r)
                log(json.dumps(r))
                if "vs_library_fwd" in r:
                    f_tc = s.fwd if r["route"] == "tc" else 0
                    b_tc = s.bwd if r["route_bwd"] == "tc" else 0
                    log(f"ratio: train_flash_attention {r['site']} {r['Tq']}x{r['Tk']} "
                        f"(B={r['B']}, Dh {r['Dh']}): kernel/SDPA fwd {r['vs_library_fwd']:.3f} bwd "
                        f"{r['vs_library_bwd']:.3f}, kernel/bound fwd {r['vs_bound_fwd']:.2f} "
                        f"bwd {r['vs_bound_bwd']:.2f}; launches per step {s.fwd} + {s.bwd}: "
                        f"{f_tc} + {b_tc} tensor cores, {s.fwd - f_tc} + {s.bwd - b_tc} "
                        f"SIMT")
    return results


def check_backward_determinism(s: TrainSite, device, seed: int = 0) -> dict:
    """Two backward calls of the kernel on the same bf16 inputs (ragged
    masks, one all-masked row) must give bit-identical dq, dk and dv: the
    split has no atomics.  The comparison's launches are not counted."""
    fn = train_ops.train_flash_attention
    counts = _counters(fn)
    q, k, v, km, do = _site_inputs(s, torch.bfloat16, device, seed)
    o, lse = train_ops._forward(q, k, v, km, s.causal)
    first = train_ops._backward(q, k, v, km, o, lse, do, s.causal)
    second = train_ops._backward(q, k, v, km, o, lse, do, s.causal)
    if device.type == "cuda":
        torch.cuda.synchronize()
    same = {name: bool(torch.equal(a, b)) for name, a, b in zip(("dq", "dk", "dv"), first, second)}
    tc = fn.backward_launches_tc - counts[3]
    _restore(fn, counts)
    log(f"determinism: train_flash_attention backward at {s.name} (B={s.B}, {s.Tq}x{s.Tk}, "
        f"Dh {s.Dh}, {'tensor cores' if tc == 2 else 'SIMT'}): "
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


def _step_totals(timed: list[dict]) -> dict:
    """Σ over sites of launches × time for one train step: the kernel, the
    plain version, SDPA and the bound (with what bounds most of it)."""

    def total(key):
        vals = [per_step(r, key) for r in timed]
        return None if not vals or any(v is None for v in vals) else sum(vals)

    bound = {"bytes": 0.0, "operations": 0.0}
    for r in timed:
        bound[r["fwd_bound_by"]] += r["fwd"] * r["fwd_bound_ms"]
        bound[r["bwd_bound_by"]] += r["bwd"] * r["bwd_bound_ms"]
    return {"ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": sum(bound.values()) if timed else None,
            "bound_by": "bytes" if bound["bytes"] >= bound["operations"] else "operations",
            "library_ms": total("library_ms"),
            "launches_tc": sum(r["fwd"] * (r.get("route") == "tc") +
                               r["bwd"] * (r.get("route_bwd") == "tc") for r in timed)}


def train_kernel_summary(results: list[dict], runs: list[tuple[str, int, int, int]],
                         eval_runs=(), runs_tc: dict | None = None) -> dict:
    """The training kernel's line.  ``runs``: (path, forward and backward
    launches per step, launches counted over the path's run) for each train
    path driven; each path gets its per-step sums over its timed sites (with
    ``launches_tc``, those of its sites' launches on the tensor cores), and
    the top level sums one step of every path.  ``eval_runs``, alike per
    eval or serving batch (the AR's val loss, the AR prefill), are listed
    under ``paths`` but not summed.  ``runs_tc``: per path, the run's
    launches counted on the tensor cores (``launches_tc_run``)."""
    paths = {}
    for path, fwd, bwd, run_launches in [*runs, *eval_runs]:
        timed = [r for r in results if r["path"] == path and "ms_fwd" in r and (r["fwd"] or r["bwd"])]
        paths[path] = {"launches": fwd + bwd, "launches_fwd": fwd, "launches_bwd": bwd,
                       "launches_run": run_launches, **_step_totals(timed)}
        if runs_tc and path in runs_tc:
            paths[path]["launches_tc_run"] = runs_tc[path]
    trained = [paths[r[0]] for r in runs]

    def total(key):
        vals = [p[key] for p in trained]
        return None if not vals or any(v is None for v in vals) else sum(vals)

    ops = sum(p["bound_ms"] or 0.0 for p in trained if p["bound_by"] == "operations")
    nbytes = sum(p["bound_ms"] or 0.0 for p in trained if p["bound_by"] == "bytes")
    return {
        "name": "train_flash_attention",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": sum(p["launches"] for p in trained),
        "launches_tc": sum(p["launches_tc"] for p in trained),
        "launches_run": sum(p["launches_run"] for p in paths.values()),
        "launches_tc_run": sum(p.get("launches_tc_run", 0) for p in paths.values()),
        "max_abs_err": max(r["max_abs_err"] for r in results if r["dtype"] == "bfloat16"),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if nbytes >= ops else "operations",
        "library_ms": total("library_ms"),
        "per": "one train step of each path (" + ", ".join(r[0] for r in runs) + "): sum over its "
               "attention sites of forward and backward launches x time",
        "paths": paths,
    }


# ---------------- 6. the train CLI ----------------

class _Records(logging.Handler):
    """Keeps the messages of one logger (the eval lines), each with the
    host clock and ``snapshot()`` (the kernels' counters) at its emission."""

    def __init__(self, snapshot=lambda: None):
        super().__init__(logging.INFO)
        self.lines: list[str] = []
        self.marks: list[tuple[str, float, object]] = []
        self.snapshot = snapshot

    def emit(self, record):
        msg = record.getMessage()
        self.lines.append(msg)
        self.marks.append((msg, time.perf_counter(), self.snapshot()))


def _eval_decodes(marks) -> list[dict]:
    """Each eval decode, between its split's ``Eval:`` line (the val loss
    is done) and its ``Eval metrics:`` line (wavs and metrics written):
    seconds, and the serving kernel's launches, the training kernel's
    forward and backward launches and the plain calls it made."""
    out = []
    for (m0, t0, c0), (m1, t1, c1) in zip(marks, marks[1:]):
        if m0.startswith("Eval:") and m1.startswith("Eval metrics:"):
            metrics = json.loads(m1[len("Eval metrics: "):].rstrip("."))
            out.append({"name": metrics["name"], "seconds": t1 - t0,
                        **{k: b - a for k, a, b in zip(
                            ("kernel1", "kernel2_fwd", "kernel2_bwd", "plain"), c0, c1)},
                        "metrics": metrics})
    return out


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


def phase_train(device, yaml: Path = TRAIN_YAML, seed: int = 0, steps: int = 8, overrides=(),
                corpus=None, run_name: str | None = None) -> dict:
    """``train.main`` on the recipe ``yaml`` with its paths pointed into
    ``build/smoke/<recipe>`` (``_<run_name>`` appended when given) and
    ``steps`` steps, checkpoint and eval at the last; then the checks.
    ``overrides`` (``key=value``) shrink the model for CPU rehearsals or
    name another model; ``corpus`` = (speakers, utterances, frames,
    phones)."""
    from .config import Config
    from .train import train as train_cli
    from .train import trainer

    data = SMOKE_DIR / "train_data"
    out = SMOKE_DIR / f"train_{Path(yaml).parent.name}_{Path(yaml).stem}"
    if run_name:
        out = out.with_name(f"{out.name}_{run_name}")
    for d in (data, out):
        shutil.rmtree(d, ignore_errors=True)
    n_spk, n_utt, frames, phones = corpus or (8, 12, (60, 168), (3, 50))
    write_train_corpus(data, n_spk, n_utt, seed, frames, phones)
    argv = [f"yaml={yaml}", f"data_dirs=[{data}]", f"log_root={out / 'logs'}",
            f"ckpt_root={out / 'ckpts'}", f"max_iter={steps}", f"eval_every={steps}",
            f"save_ckpt_every={steps}", *overrides]
    cfg = Config.from_cli(argv)
    log(f"train: {' '.join(argv)}")

    fn, serve = train_ops.train_flash_attention, serve_ops.masked_attention
    records, tc = [], []

    def step_logger(data):
        trainer.logger(data)
        records.append((data, fn.launches, fn.backward_launches, fn.plain_calls))
        tc.append(fn.launches_tc + fn.backward_launches_tc)

    def counts():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (serve.launches, fn.launches, fn.backward_launches,
                serve.plain_calls + fn.plain_calls)

    evals, loader_lines = _Records(counts), _Records()
    train_logger = logging.getLogger(train_cli.__name__)
    data_logger = logging.getLogger(dataset.__name__)
    train_logger.addHandler(evals)
    data_logger.addHandler(loader_lines)
    fn.launches = fn.launches_tc = fn.backward_launches = fn.backward_launches_tc = 0
    fn.plain_calls = serve.launches = serve.plain_calls = 0
    # the run's own peak: memory that earlier phases still hold is left out
    held = torch.cuda.memory_allocated(device) if device.type == "cuda" else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        engines = train_cli.main(cfg, logger=step_logger)
    finally:
        train_logger.removeHandler(evals)
        data_logger.removeHandler(loader_lines)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - held if device.type == "cuda" else None
    engine = engines["model"]
    on_card = device.type == "cuda"

    # launches per step against the count derived from the model's config
    bucket = min(b for b in cfg.resp_len_buckets)
    sites = step_sites(engine.module, cfg)
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
    if on_card:
        check(all(c == (want_fwd, want_bwd, 0) for c in per_step_counts),
              f"kernel launches per step {per_step_counts} != ({want_fwd}, {want_bwd}, 0)")
    else:  # the plain version stands in for every forward, remat included
        check(all(c[2] == want_fwd for c in per_step_counts),
              f"plain calls per step {[c[2] for c in per_step_counts]} != {want_fwd}")

    # the val-loss eval ran, under no_grad (forwards only), through the
    # kernel that route.attend picks for the model's attention; the training
    # kernel's eval launches are those after the last step's record
    eval_lines = [ln for ln in evals.lines if ln.startswith("Eval:")]
    check(len(eval_lines) == 2, f"{len(eval_lines)} eval lines != 2 (subtrain, val)")
    decodes = _eval_decodes(evals.marks)
    check(len(decodes) == (2 if cfg.eval_decode_audio else 0),
          f"{len(decodes)} eval decodes with eval_decode_audio={cfg.eval_decode_audio}")
    eval_kernel, per_eval_batch = eval_attentions(engine.module)
    if eval_kernel == "masked_attention":
        served = (serve.launches if on_card else serve.plain_calls) - sum(
            d["kernel1" if on_card else "plain"] for d in decodes)
    else:
        check(fn.backward_launches == prev[1], "the eval ran a backward")
        served = (fn.launches - prev[0] if on_card else fn.plain_calls - prev[2]) - sum(
            d["kernel2_fwd" if on_card else "plain"] for d in decodes)
    if per_eval_batch:
        check(served > 0 and served % per_eval_batch == 0,
              f"eval {eval_kernel} calls {served} are not a positive multiple of "
              f"{per_eval_batch}")
    else:  # a model without kernel sites (the UNet2DCondition)
        check(served == 0, f"eval {eval_kernel} calls {served} from a model without sites")
    if on_card:
        check(serve.plain_calls == fn.plain_calls == 0, "a plain version ran on the card")

    # the weights moved, and the checkpoint reloads into a fresh engine
    init = train_cli.build_model(cfg, device)
    train_cli.init_params(cfg, init)
    moved = max((a - b).abs().max().item() for a, b in
                zip(engine.module.parameters(), init.parameters()))
    ema_moved = max((a - b).abs().max().item() for a, b in zip(engine.ema, init.parameters()))
    del init
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
    del fresh, opt_a, opt_b
    check(same, "the reloaded engine differs from the trained one")

    loader = "native" if "Training batches from the native loader" in loader_lines.lines else (
        "python" if "Training batches from the python loader" in loader_lines.lines else None)
    check(loader is not None, "the loader's choice was not logged")
    times = [r[0]["elapsed_time"] for r in records]
    p50 = float(np.median(times[1:] if len(times) > 1 else times))
    p90 = float(np.percentile(times[1:] if len(times) > 1 else times, 90))
    frames = cfg.batch_size * bucket
    out_d = {"engines": engines, "cfg": cfg, "steps": steps, "wall_s": wall, "step_s": times,
             "p50_step_s": p50, "p90_step_s": p90, "frames_per_s": frames / p50,
             "peak_bytes": peak, "held_bytes": held, "loader": loader, "decodes": decodes,
             "fwd_per_step": want_fwd, "bwd_per_step": want_bwd,
             "run_launches": prev[0] + prev[1], "run_launches_tc": tc[-1] if tc else 0,
             "eval_kernel": eval_kernel,
             "eval_launches": served, "eval_per_batch": per_eval_batch, "eval": eval_lines,
             "moved": moved, "ema_moved": ema_moved,
             "losses": [r[0]["model.loss"] for r in records], "sites": sites,
             "checkpoint": str(ckpt), "argv": argv}
    where = "host clock around synchronised steps" if on_card else "cpu"
    mem = "n/a" if peak is None else (f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB "
                                      "held before the run")
    log(f"train {cfg.model}: {steps} steps in {wall:.1f} s on the {loader} loader; step p50 "
        f"{p50 * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms ({where}), first {times[0] * 1e3:.1f} ms; "
        f"{out_d['frames_per_s']:.0f} padded frames/s "
        f"(B={cfg.batch_size} x bucket {bucket}); peak allocated {mem}")
    log(f"train {cfg.model}: kernel launches per step {per_step_counts[0]} (fwd, bwd, plain) = "
        f"{want_fwd} fwd + {want_bwd} bwd derived from the config, {out_d['run_launches_tc']} of "
        f"the run's {out_d['run_launches']} on the tensor cores; eval: {served} {eval_kernel} "
        f"calls ({per_eval_batch} per batch); losses {[round(x, 4) for x in out_d['losses']]}")
    return out_d
