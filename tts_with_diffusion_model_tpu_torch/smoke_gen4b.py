"""The gen4b training phase and the remat-policy check of the port's smoke
run (``chip_smoke.py`` drives them on the card at full width; the CPU tests
rehearse them at a tiny size with the plain versions).

8. train gen4b — the train CLI's ``main`` on ``config/gen4b/diffusion.yml``,
   ``nar.yml`` and ``ar.yml`` as committed (B=64, ``eval_decode_audio`` at
   ``eval_batch_size`` 32), paths pointed into ``build/smoke/``, cut to 4
   steps with an eval tick at step 4; then a D3PM run of 2 steps traced
   with ``profile_every`` 2, apart from the timed runs so that no timed
   step or eval decode runs under the profiler.  Checked: the native loader was taken and its library built into
   ``build/torch_kernels/``; kernel-2 launches per step; each eval
   decode's launches against the count its attention sites give (the
   D3PM's ancestral chain on kernel 1, the NAR's seven levels on kernel 1,
   the AR's prefill on kernel 2's forward) with no plain call; hyp / ref
   wavs and ``metrics.json`` per split; the D3PM's trace.
9. remat policies — one gen4c D3PM step and one NAR step under each
   ``gradient_checkpointing_policy`` on the same weights, batch and
   generator seed: every gradient equal to whole-block recompute's within
   fp32 rounding, the same kernel-2 launches, and the peak memory and step
   time of each policy.

``python -m tts_with_diffusion_model_tpu_torch.smoke_gen4b`` runs the
kernels' build and these two phases alone on the card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from .data import native_loader
from .ops import train_flash_attention as train_ops
from .ops._build import BUILD_DIR
from .smoke import REPO, SMOKE_DIR, Site, check, expected_launches, log
from .smoke_train import (NAR_YAML, TRAIN_YAML, TrainSite, phase_train, recipe, step_sites,
                          write_train_corpus)

RECIPES = {"d3pm": REPO / "config" / "gen4b" / "diffusion.yml",
           "nar": REPO / "config" / "gen4b" / "nar.yml",
           "ar": REPO / "config" / "gen4b" / "ar.yml"}
STEPS = 4
#: the D3PM's traced run (``profile_every`` 2), apart from the timed one: a
#: window of 2 steps from step 2 runs past its last step, so it holds step
#: 2's train step (kernel 2) and val-loss eval (kernel 1), and the loop's
#: end closes it
TRACED_STEPS = 2
PROFILE = ("profile_every=2", "profile_n_steps=2", "eval_decode_audio=false")
#: CUDA kernel names of each attention library in a trace
LIBRARY_KERNELS = {"masked_attention": ("fwd_kernel<false,", "masked_attention_kernel"),
                   "train_flash_attention": ("fwd_kernel<true,", "wgmma_kernel",
                                             "bwd_dkdv_kernel", "bwd_dq_kernel")}
POLICIES = (None, "dots", "dots_all", "nothing")
#: a policy's gradient against whole-block recompute's: the same arithmetic,
#: so only fp32 rounding (relative to each tensor's largest magnitude)
REMAT_TOL = 1e-6


# ---------------- the eval decode's attention sites ----------------

def decode_sites(yaml: Path) -> dict:
    """The attention sites of one eval decode batch of the recipe ``yaml``
    (B = ``eval_batch_size``) and the kernel they run: the diffusion model's
    ancestral chain (its towers once, then every block's three attentions
    per process step) and the NAR's seven levels on the serving kernel at
    the eval loader's bucket; the AR's prefill (text + sep + prompt + sep)
    on the training kernel's forward, one launch per block."""
    from .models.diffusion import ancestral_schedule

    cfg, model = recipe(yaml)
    B = cfg.eval_batch_size
    if hasattr(model, "denoiser"):
        c, den = model.config, model.denoiser
        H, Dh = c.n_heads, c.d_model // c.n_heads
        n = len(ancestral_schedule(c.timesteps, 1)[0]) * c.n_layers
        sites = [Site("text tower self", c.text_len, c.text_len, H, Dh, den.text_tower.n_layers),
                 Site("prompt tower self", c.prom_len, c.prom_len, H, Dh,
                      den.prom_tower.n_layers),
                 Site("DiT self", c.resp_len, c.resp_len, H, Dh, n),
                 Site("DiT text cross", c.resp_len, c.text_len, H, Dh, n),
                 Site("DiT prompt cross", c.resp_len, c.prom_len, H, Dh, n)]
        return {"kernel": "masked_attention", "B": B, "sites": sites,
                "expected": expected_launches(sites)}
    base = model.base
    attn = base.blocks()[0].attn
    H, Dh = attn.n_heads, attn.d_model // attn.n_heads
    if attn.causal:
        T = cfg.max_text_len + 1 + cfg.max_prom_len + 1
        site = TrainSite("AR eval decode prefill causal self", B, T, T, H, Dh, True,
                         base.n_layers, 0, path="eval decode ar", fused=True,
                         layout=(cfg.max_text_len, cfg.max_prom_len))
        return {"kernel": "train_flash_attention", "B": B, "sites": [site],
                "expected": site.fwd}
    T = cfg.max_text_len + 1 + cfg.max_prom_len + 1 + cfg.max_resp_len
    sites = [Site("NAR eval decode self", T, T, H, Dh, 7 * base.n_layers)]
    return {"kernel": "masked_attention", "B": B, "sites": sites,
            "expected": expected_launches(sites)}


def train_sites() -> list[TrainSite]:
    """The training kernel's sites in one train step of each gen4b recipe
    (B=64), under paths "gen4b d3pm", "gen4b nar" and "gen4b ar"."""
    out = []
    for family, yaml in RECIPES.items():
        cfg, model = recipe(yaml)
        out += [dataclasses.replace(s, path=f"gen4b {family}") for s in step_sites(model, cfg)]
    return out


# ---------------- 8. train gen4b ----------------

def _trace_kernels(path: Path) -> set[str]:
    """Names of the CUDA kernel events in a Chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def _check_outputs(cfg, family: str) -> dict:
    """hyp / ref wavs and ``metrics.json`` of the step's eval decode, per
    split; returns the means."""
    means = {}
    for split in ("subtrain", "val"):
        out = Path(cfg.log_dir) / str(STEPS) / split
        for d in ("hyp", "ref"):
            check(any((out / d).glob("*.wav")), f"{family} {split}: no {d} wav under {out}")
        mean = json.loads((out / "metrics.json").read_text())["mean"]
        check(mean["n_utts"] >= 1 and 0.0 <= mean["acc"] <= 1.0,
              f"{family} {split}: metrics {mean}")
        check(math.isfinite(mean.get("mcd", float("nan"))) and mean["mcd"] >= 0.0,
              f"{family} {split}: mcd {mean.get('mcd')}")
        means[split] = mean
    return means


def phase_gen4b(device, seed: int = 0, overrides=(), corpus=None, smi: str = "n/a") -> dict:
    """The three gen4b recipes, 4 steps each and an eval tick at step 4 with
    ``eval_decode_audio``, through ``smoke_train.phase_train``; then the
    D3PM's traced run, and the checks.  ``overrides`` shrink the models for
    CPU rehearsals."""
    on_card = device.type == "cuda"
    out = {}
    for family, yaml in RECIPES.items():
        tr = phase_train(device, yaml, seed=seed, steps=STEPS, overrides=overrides, corpus=corpus)
        cfg = tr["cfg"]
        check(tr["loader"] == "native", f"{family}: the {tr['loader']} loader was taken")
        lib = native_loader.library_path()
        check(lib.exists() and lib.parent == BUILD_DIR, f"no native loader library at {lib}")
        want = decode_sites(yaml) if not overrides else None
        for d in tr["decodes"]:
            total = d["kernel1"] + d["kernel2_fwd"] + d["plain"]
            if on_card:
                key = "kernel1" if want["kernel"] == "masked_attention" else "kernel2_fwd"
                check(d[key] == want["expected"] and total == want["expected"] and
                      d["kernel2_bwd"] == 0,
                      f"{family} eval decode {d['name']}: launches {d} != {want['expected']} "
                      f"{want['kernel']}")
            else:
                check(d["plain"] == total > 0, f"{family} eval decode {d['name']}: {d}")
        means = _check_outputs(cfg, family)
        res = {"p50_step_s": tr["p50_step_s"], "p90_step_s": tr["p90_step_s"],
               "frames_per_s": tr["frames_per_s"], "peak_bytes": tr["peak_bytes"],
               "fwd_per_step": tr["fwd_per_step"], "bwd_per_step": tr["bwd_per_step"],
               "run_launches": tr["run_launches"], "decodes": tr["decodes"], "metrics": means,
               "expected_decode": None if want is None else want["expected"],
               "argv": tr["argv"], "batch_size": cfg.batch_size}
        peak = "n/a" if tr["peak_bytes"] is None else f"{tr['peak_bytes'] / 2**30:.2f} GiB"
        log(f"train gen4b {family}: B={cfg.batch_size} step p50 {tr['p50_step_s'] * 1e3:.1f} ms, "
            f"p90 {tr['p90_step_s'] * 1e3:.1f} ms, {tr['frames_per_s']:.0f} padded frames/s, "
            f"peak allocated {peak}; eval decode "
            + ", ".join(f"{d['name']} {d['seconds']:.2f} s ({d['kernel1']} kernel-1, "
                        f"{d['kernel2_fwd']} kernel-2 fwd, {d['plain']} plain)"
                        for d in tr["decodes"])
            + f"; val acc {means['val']['acc']:.4f} mcd {means['val']['mcd']:.3f}; on {smi}")
        out[family] = res
        del tr
        if on_card:
            torch.cuda.empty_cache()
    tr = phase_train(device, RECIPES["d3pm"], seed=seed, steps=TRACED_STEPS,
                     overrides=[*PROFILE, *overrides], corpus=corpus)
    trace = Path(tr["cfg"].log_dir) / "profile" / "step_2" / "trace.json"
    del tr
    check(trace.exists(), f"no trace at {trace}")
    names = _trace_kernels(trace)
    out["d3pm"]["trace_bytes"] = trace.stat().st_size
    if on_card:
        for lib_name, marks in LIBRARY_KERNELS.items():
            check(any(m in n for n in names for m in marks),
                  f"the trace names no {lib_name} kernel: {sorted(names)[:20]}")
        torch.cuda.empty_cache()
    log(f"train gen4b d3pm traced: {trace} ({out['d3pm']['trace_bytes']} bytes), "
        f"{len(names)} distinct CUDA kernels")
    return out


# ---------------- 9. remat policies ----------------

def _remat_batch(cfg, bucket, seed: int) -> dict:
    """One training batch of the recipe from a seeded corpus, through its
    own loader."""
    from .data.dataset import create_train_val_dataloader

    data = SMOKE_DIR / "remat_data"
    if not data.exists():
        write_train_corpus(data, seed=seed)
    cfg = dataclasses.replace(cfg, data_dirs=[data])
    train_dl, _, _ = create_train_val_dataloader(cfg, bucket)
    it = iter(train_dl)
    try:
        return next(it)
    finally:
        it.close()
        getattr(train_dl, "close", lambda: None)()


def remat_step(cfg, device, batch: dict, seed: int, timed: int = 3) -> dict:
    """Loss and backward of the recipe ``cfg`` (seeded weights, the step
    generator seeded with ``seed`` each time): one warm-up, then ``timed``
    steps.  Returns the last step's gradients (on the host, so they hold no
    device memory), the median step ms (host clock around a synchronised
    step), the largest peak allocated memory of a step and the kernel-2
    launches of one step."""
    from .train.engine import batch_to_device
    from .train.train import build_model, init_params, make_loss_fn

    model = build_model(cfg, device)
    init_params(cfg, model)
    loss_fn = make_loss_fn(cfg, model)
    arrays = batch_to_device(batch, device)
    gen = torch.Generator(device=device)
    fn = train_ops.train_flash_attention
    on_card = device.type == "cuda"
    times, peak = [], 0
    for i in range(1 + timed):
        for p in model.parameters():
            p.grad = None
        gen.manual_seed(seed)
        before = (fn.launches, fn.backward_launches, fn.plain_calls)
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, arrays, gen)
        loss.backward()
        if on_card:
            torch.cuda.synchronize(device)
            peak = max(peak, torch.cuda.max_memory_allocated(device)) if i else 0
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": float(loss.detach()), "grads": [p.grad.detach().cpu() for p in model.parameters()],
            "ms": float(np.median(times)), "peak_bytes": peak if on_card else None,
            "launches": (fn.launches - before[0], fn.backward_launches - before[1],
                         fn.plain_calls - before[2])}


def phase_remat(device, seed: int = 0, overrides=(), smi: str = "n/a") -> dict:
    """Each policy against whole-block recompute on one gen4c D3PM step and
    one NAR step."""
    from .config import Config
    from .train.train import build_model, make_bucket

    out = {}
    for family, yaml in (("d3pm", TRAIN_YAML), ("nar", NAR_YAML)):
        base = Config.from_cli([f"yaml={yaml}", *overrides])
        with torch.device("meta"):
            bucket = make_bucket(base, build_model(base))
        batch = _remat_batch(base, bucket, seed)
        runs = {}
        for policy in POLICIES:
            cfg = dataclasses.replace(base, gradient_checkpointing_policy=policy)
            runs[policy] = remat_step(cfg, device, batch, seed)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        ref = runs[None]
        rows = {}
        for policy, r in runs.items():
            err = max((g - g0).abs().max().item() / max(1.0, g0.abs().max().item())
                      for g, g0 in zip(r["grads"], ref["grads"]))
            check(err <= REMAT_TOL, f"{family} remat {policy}: gradient differs from null's "
                                    f"by {err:.3g} (relative) > {REMAT_TOL:g}")
            check(r["launches"] == ref["launches"],
                  f"{family} remat {policy}: kernel-2 launches {r['launches']} != "
                  f"{ref['launches']} (null)")
            rows[str(policy)] = {"ms": r["ms"], "peak_bytes": r["peak_bytes"], "max_rel_err": err,
                                 "launches": r["launches"], "loss": r["loss"]}
            peak = "n/a" if r["peak_bytes"] is None else f"{r['peak_bytes'] / 2**30:.3f} GiB"
            log(f"remat {family} {policy}: step {r['ms']:.1f} ms, peak allocated {peak}, "
                f"kernel-2 launches (fwd, bwd, plain) {r['launches']}, gradient vs null "
                f"{err:.3g} relative; on {smi}")
        out[family] = rows
        del runs, ref
    return out


def main(argv=None) -> int:
    import argparse

    from .smoke import phase, phase_build, phase_device

    parser = argparse.ArgumentParser(description="the train gen4b phase and the remat-policy "
                                                 "check alone, on the card")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device = torch.device("cuda", 0)
    info = phase_device(device)  # raises without a card
    with phase("build"):
        phase_build(device)
    with phase("train gen4b"):
        phase_gen4b(device, seed=args.seed, smi=info["smi"])
    with phase("remat policies"):
        phase_remat(device, seed=args.seed, smi=info["smi"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
