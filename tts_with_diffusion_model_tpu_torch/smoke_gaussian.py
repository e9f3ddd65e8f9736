"""The Gaussian family's phase of the port's smoke run (``chip_smoke.py``
drives it on the card at full width after the other phases; the CPU tests
rehearse it at a tiny size with the plain versions).

8. gaussian kernel — both kernels against their plain versions at every
   attention site the Gaussian denoisers give them (head widths 32, 16 and
   8: the DiT's and its towers', the ``-unet`` bottleneck core's, the
   conv-UNet's cross-attentions per level), serving shapes for the
   forward-only kernel and training shapes for the training kernel, every
   bf16 call on the tensor cores;
9. train -> export -> serve gaussian — for each variant of ``VARIANTS``:
   the train CLI on ``config/gen4c/diffusion.yml`` with ``model=<name>``
   (launches per step held to the sites, the val-loss eval), export
   ``--ema`` with the bundle held bit for bit to the engine's EMA (or, for
   the published-width ``-unet2d-ref``, seeded weights and no export), and
   a ``Synthesizer`` over it and the exported NAR answering 4 requests
   (kernel-1 launches held to the sites, the codes, the wavs, the padding
   tail of the first stage, the same seeds again, the p50), then each
   request's fp32 codes alone and in a cohort of 4 through the ``Batcher``.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from .ops import masked_attention as serve_ops
from .smoke import (SMOKE_DIR, TEXTS, Site, check, default_symmap, full_fp32, log,
                    make_requests, phase_site_check, reference_wavs)
from .smoke_train import TRAIN_YAML, TrainSite

#: (registry name, train steps, exported); the last runs at the published
#: widths from seeded weights and is not exported (a 3.6 GB bundle)
VARIANTS = (("diffusion-gaussian", 8, True), ("diffusion-gaussian-unet2d", 8, True),
            ("diffusion-gaussian-unet2d-ref", 2, False))
#: the kernel-only variant: its sites join the kernel check, nothing else
UNET_CORE = "diffusion-gaussian-unet"


def path_name(model_name: str) -> str:
    """The kernels line's path of a Gaussian variant: ``gaussian dit``,
    ``gaussian unet2d``, ``gaussian unet2d-ref``, ..."""
    return "gaussian " + (model_name.removeprefix("diffusion-gaussian").lstrip("-") or "dit")


def _levels(model, Tr: int) -> list[tuple[str, int, int]]:
    """(name, query length, channels) of each conv-UNet cross-attention in
    the order a denoiser call runs them (down levels, mid, up levels),
    named by level: a level's down, mid and up attentions share a shape."""
    chs = list(model.config.unet_channels)
    lens = [Tr]
    for _ in chs[1:]:
        lens.append(-(-lens[-1] // 2))
    last = len(chs) - 1
    return ([(f"conv-UNet level {i} cross", lens[i], c) for i, c in enumerate(chs)]
            + [(f"conv-UNet level {last} cross", lens[-1], chs[-1])]
            + [(f"conv-UNet level {last - i} cross", lens[last - i], c)
               for i, c in enumerate(reversed(chs))])


def denoiser_sites(model, Tr: int, prompt_bucket: int) -> tuple[list, list]:
    """The attention sites of a Gaussian model → (the towers' sites, run
    once per utterance; one denoiser call's sites), each as (name, Tq, Tk,
    heads, head width).  The UNet2DCondition's attention launches no
    kernel: both lists are empty for it."""
    c = model.config
    if c.denoiser == "unet2d-ref":
        return [], []
    H = c.n_heads
    towers = [("text tower self", c.text_len, c.text_len, H, c.d_model // H),
              ("prompt tower self", prompt_bucket, prompt_bucket, H, c.d_model // H)]
    if c.denoiser == "conv-unet":
        Tk = prompt_bucket + c.text_len  # keys: the prompt, then the text
        return towers, [(n, Tq, Tk, H, ch // H) for n, Tq, ch in _levels(model, Tr)]
    Dh = model.denoiser.core_dim // H
    per_block = [("DiT self", Tr, Tr, H, Dh), ("DiT text cross", Tr, c.text_len, H, Dh),
                 ("DiT prompt cross", Tr, prompt_bucket, H, Dh)]
    return towers, per_block * c.n_layers


def _merge(entries, counts) -> list[tuple]:
    """(name, Tq, Tk, H, Dh) entries with their counts summed by name."""
    out: dict[tuple, int] = {}
    for e, n in zip(entries, counts):
        out[e] = out.get(e, 0) + n
    return [(*e, n) for e, n in out.items()]


def serve_sites(model, nar_dims: dict, prompt_bucket: int) -> list[Site]:
    """The forward-only kernel's sites of one served batch: the towers once
    (2 layers each), ``timesteps`` denoiser calls, the NAR's 7 levels over
    text + sep + prompt + sep + gen_len slots."""
    c = model.config
    towers, step = denoiser_sites(model, c.resp_len, prompt_bucket)
    merged = _merge([*towers, *step], [2] * len(towers) + [c.timesteps] * len(step))
    sites = [Site(*e) for e in merged]
    packed = c.text_len + 1 + prompt_bucket + 1 + c.gen_len
    nH = nar_dims["n_heads"]
    sites.append(Site("NAR packed self", packed, packed, nH, nar_dims["d_model"] // nH,
                      7 * nar_dims["n_layers"]))
    return sites


def train_sites(model, B: int, bucket: int, path: str) -> list[TrainSite]:
    """The training kernel's sites of one train step at batch ``B`` and
    response bucket ``bucket``: the towers' layers forward and backward,
    each denoiser site forward (twice per DiT block under remat) and
    backward."""
    c = model.config
    towers, step = denoiser_sites(model, bucket, c.prom_len)
    remat = 2 if c.denoiser == "dit" and c.remat else 1
    entries = [*towers, *step]
    fwd = [2] * len(towers) + [remat] * len(step)
    bwd = [2] * len(towers) + [1] * len(step)
    f, b = _merge(entries, fwd), _merge(entries, bwd)
    return [TrainSite(n, B, Tq, Tk, H, Dh, False, nf, nb, path=path)
            for (n, Tq, Tk, H, Dh, nf), (*_, nb) in zip(f, b)]


def eval_launches(model) -> int:
    """Forward-only kernel launches per val-loss eval batch: the towers'
    layers and one denoiser call."""
    towers, step = denoiser_sites(model, model.config.resp_len, model.config.prom_len)
    return 2 * len(towers) + len(step)


# ---------------- 8. the kernels at the Gaussian sites ----------------

def _registry(name: str):
    """The model ``diffusion.yml`` trains under ``model=name`` (remat from
    its ``gradient_checkpointing``), parameters on the meta device."""
    from .config import Config
    from .train.train import build_model

    cfg = Config.from_cli([f"yaml={TRAIN_YAML}", f"model={name}"])
    with torch.device("meta"):
        return build_model(cfg)


def kernel_sites(prompt_bucket: int, B_serve: int, B_train: int, bucket: int):
    """The new sites of both kernels: (serving Sites of kernel 1 at
    ``B_serve``, each shape once; TrainSites of kernel 2 at ``B_train`` and
    ``bucket``, each path's own),
    over the DiT (Dh 32), its ``-unet`` core (Dh 8) and the conv-UNet
    (Dh 8 / 16 / 32).  Counts are per served batch and per train step of
    the variant that runs the site (the ``-unet`` core's: 0, no run)."""
    serve, train = [], []
    for name in ("diffusion-gaussian", "diffusion-gaussian-unet2d", UNET_CORE):
        model, path = _registry(name), path_name(name)
        for s in serve_sites(model, {"d_model": 1024, "n_heads": 16, "n_layers": 12},
                             prompt_bucket)[:-1]:
            if not any((t.Tq, t.Tk, t.H, t.Dh) == (s.Tq, s.Tk, s.H, s.Dh) for t in serve):
                serve.append(dataclasses.replace(
                    s, name=f"{path}: {s.name}", count=0 if name == UNET_CORE else s.count))
        for s in train_sites(model, B_train, bucket, path):
            if name == UNET_CORE:
                s = dataclasses.replace(s, fwd=0, bwd=0)
            # per path: a train path's step totals sum its own sites
            train.append(dataclasses.replace(s, name=f"{path}: {s.name}"))
    return serve, train


#: kernel 2's training sites whose backward is run twice and held
#: bit-identical: one at each head width below 64
DETERMINISM_SITES = ("gaussian dit: DiT self", "gaussian unet2d: conv-UNet level 1 cross",
                     "gaussian unet2d: conv-UNet level 0 cross")


def check_unaligned(site: Site, B: int, train: TrainSite, device, seed: int = 0):
    """One bf16 call of each kernel on unaligned views of a site's inputs
    (``smoke.unaligned``): it takes the SIMT kernels and agrees with the
    plain version.  Its launches are not counted."""
    from . import smoke_train
    from .ops import train_flash_attention as train_ops
    from .smoke import TOL, _inputs, unaligned

    bf16 = torch.bfloat16
    fn, tfn = serve_ops.masked_attention, train_ops.train_flash_attention
    counts, tcounts = (fn.launches, fn.launches_tc), smoke_train._counters(tfn)
    q, k, v, mask = _inputs(B, site.Tq, site.Tk, site.H, site.Dh, bf16, device, seed)
    got = fn(unaligned(q), unaligned(k), unaligned(v), mask)
    errs = [(got.float() - serve_ops.masked_attention_plain(q, k, v, mask).float()).abs().max()]
    q, k, v, km, do = smoke_train._site_inputs(train, bf16, device, seed)
    got = smoke_train._fwd_bwd(tfn, unaligned(q), unaligned(k), unaligned(v), km, train.causal,
                               unaligned(do))
    ref = smoke_train._fwd_bwd(train_ops.train_flash_attention_plain, q, k, v, km,
                               train.causal, do)
    errs += [(a.float() - b.float()).abs().max() / max(1.0, b.float().abs().max().item())
             for a, b in zip(got, ref)]
    tc = (fn.launches_tc - counts[1], tfn.launches_tc - tcounts[1],
          tfn.backward_launches_tc - tcounts[3])
    fn.launches, fn.launches_tc = counts
    smoke_train._restore(tfn, tcounts)
    err = max(e.item() for e in errs)
    log(f"unaligned views: {site.name} and {train.name} in bf16 on the SIMT kernels "
        f"(tensor-core launches {tc}), max abs err {err:.3g}")
    check(tc == (0, 0, 0) and err <= TOL[bf16],
          f"unaligned bf16 views: tensor-core launches {tc}, max abs err {err:.3g}")


def phase_kernel_check(device, prompt_bucket: int, B_serve: int, B_train: int, bucket: int,
                       seed: int = 0) -> tuple[list[dict], list[dict]]:
    """Kernel 1 at every new serving site (and the registry NAR's packed
    site at the full prompt) and kernel 2 at every new training site, fp32
    and bf16 (forward, and dq / dk / dv), timed in bf16; every bf16 call on
    the tensor cores, and unaligned views on the SIMT kernels
    (``check_unaligned``); kernel 2's backward twice at Dh 32, 16 and 8
    (``DETERMINISM_SITES``), bit-identical."""
    from . import smoke_train

    serve, train = kernel_sites(prompt_bucket, B_serve, B_train, bucket)
    # the -unet2d-ref path serves the whole prompt, so its NAR packs 398 frames
    c = _registry(VARIANTS[-1][0]).config
    T = c.text_len + 1 + c.prom_len + 1 + c.gen_len
    serve.append(Site("gaussian unet2d-ref: NAR packed self", T, T, 16, 64, 84))
    serve_results = [r for s in serve for r in phase_site_check(device, s, B_serve, seed=seed)]
    train_results = smoke_train.phase_train_kernel_check(device, train, seed=seed)
    if device.type == "cuda":
        simt = [f"{r['site']} (Dh {r['Dh']})" for r in [*serve_results, *train_results]
                if r["dtype"] == "bfloat16" and {r["route"], r.get("route_bwd", "tc")} != {"tc"}]
        check(not simt, f"bf16 Gaussian sites on the SIMT kernels: {simt}")
        with full_fp32():
            check_unaligned(serve[0], B_serve, train[0], device, seed)
        for name in DETERMINISM_SITES:
            smoke_train.check_backward_determinism(next(s for s in train if s.name == name),
                                                   device, seed=seed)
    return serve_results, train_results


# ---------------- 9. train -> export -> serve ----------------

@torch.no_grad()
def serve_gaussian(synth, nar_dims: dict, requests, label: str, repeats: int) -> dict:
    """One batch of ``requests`` with the kernel counts set to 0 just before
    and read just after (a warm-up), the launches held to ``serve_sites``,
    the codes (``gen_len`` × 8 in [0, 1024)), the first stage's padding
    tail (0 beyond ``gen_len``), the wavs (finite, ``gen_len`` × 320); the
    same seeds again; then the p50 of ``repeats`` more batches."""
    device, first = synth.device, synth.first
    prepared = [synth.prepare(t, r) for t, r, _ in requests]
    seeds = [s for _, _, s in requests]
    pb = synth.prompt_bucket(prepared)
    sites = serve_sites(first, nar_dims, pb)
    expected = sum(s.count for s in sites)
    fn = serve_ops.masked_attention
    firsts = []
    generate = first.generate

    def keep(*a, **kw):
        out = generate(*a, **kw)
        firsts.append(out.cpu().numpy())
        return out

    first.generate = keep
    try:
        _sync(device)
        fn.launches, fn.launches_tc, fn.plain_calls = 0, 0, 0
        t0 = time.perf_counter()
        codes, wavs = synth._device_batch(prepared, seeds, want_wav=True)
        _sync(device)
        first_s = time.perf_counter() - t0
        launches, launches_tc, plain = fn.launches, fn.launches_tc, fn.plain_calls
    finally:
        del first.generate
    on_card = device.type == "cuda"
    log(f"{label}: first batch of {len(requests)} in {first_s:.3f} s ({synth.denoiser_calls} "
        f"denoiser calls); prompt bucket {pb}; kernel launches {launches} ({launches_tc} on the "
        f"tensor cores), plain calls {plain}, expected {expected}")
    check((launches if on_card else plain) == expected,
          f"{label}: attention calls {launches if on_card else plain} != expected {expected}")
    if on_card:
        check(plain == 0, f"{label}: the plain path ran on the card")
        check(launches_tc == launches,
              f"{label}: {launches - launches_tc} of {launches} bf16 launches on the SIMT kernels")
    gl = synth.gen_len
    toks = firsts[0]
    check(toks.shape == (len(requests), first.config.resp_len) and (toks[:, gl:] == 0).all(),
          f"{label}: first-stage tokens {toks.shape}, nonzero beyond gen_len {gl}")
    for i, (c, w) in enumerate(zip(codes, wavs)):
        check(c.shape == (gl, 8), f"{label} request {i}: codes {c.shape} != {(gl, 8)}")
        check(int(c.min()) >= 0 and int(c.max()) < 1024,
              f"{label} request {i}: codes outside [0, 1024)")
        check(w.shape == (gl * 320,) and bool(np.isfinite(w).all()),
              f"{label} request {i}: wav {w.shape} or non-finite samples")
    again, _ = synth._device_batch(prepared, seeds, want_wav=False)
    check(all(np.array_equal(a, b) for a, b in zip(codes, again)),
          f"{label}: the same seeds gave other codes")
    times = []
    for _ in range(repeats):
        _sync(device)
        t1 = time.perf_counter()
        synth.synthesize_batch(requests)
        _sync(device)
        times.append(time.perf_counter() - t1)
    p50 = float(np.median(times)) if times else None
    if p50 is not None:
        log(f"{label}: synthesize_batch of {len(requests)} p50 {p50 * 1e3:.1f} ms over "
            f"{repeats} ({'host clock around synchronised work' if on_card else 'cpu'})")
    return {"launches": launches, "launches_tc": launches_tc, "plain": plain,
            "expected": expected, "sites": sites,
            "prompt_bucket": pb, "first_s": first_s, "p50_s": p50, "times_s": times}


def path_totals(results: list[dict], sites: list[Site], launches_run: int) -> dict:
    """Per-batch sums (``smoke.batch_totals``) of a served path whose sites
    were timed in ``results`` (matched by shape), at the path's counts."""
    from .smoke import batch_totals

    timed = []
    for s in sites:
        r = next(r for r in results if "ms" in r and
                 (r["Tq"], r["Tk"], r["H"], r["Dh"]) == (s.Tq, s.Tk, s.H, s.Dh))
        timed.append(dict(r, count=s.count))
    return dict(batch_totals(timed), launches_run=launches_run)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flow(ov: dict) -> str:
    """A ``model_overrides={...}`` command-line item."""
    def val(v):
        return "[" + ", ".join(map(str, v)) + "]" if isinstance(v, (list, tuple)) else str(v)
    return "model_overrides={" + ", ".join(f"{k}: {val(v)}" for k, v in ov.items()) + "}"


def phase_gaussian(device, nar_bundle: Path, seed: int = 0, repeats: int = 3,
                   smi: str = "n/a", variants=VARIANTS, overrides=(),
                   model_overrides: dict | None = None, corpus=None, codec=None,
                   ref_seconds: float = 3.0, profile: bool = False) -> dict:
    """The phase (see the module docstring) → per variant: the train run's
    numbers, the export's, the served batch's and the cohort check's.
    ``overrides`` (``key=value`` for every run), ``model_overrides`` (per
    registry name) and ``corpus`` shrink the runs and ``codec`` replaces
    the seeded codec, for the CPU rehearsal.  ``profile`` traces one served
    batch of the DiT variant."""
    from . import smoke_export, smoke_serve, smoke_train
    from .codec.encodec import load_codec
    from .convert import init_seeded
    from .models import get_model
    from .serve import Synthesizer, load_model

    device = torch.device(device)
    codec = codec if codec is not None else load_codec(None, device=device)
    nar, _ = load_model(nar_bundle, torch.bfloat16)
    nar_dims = {"d_model": nar.base.d_model, "n_heads": nar.base.blocks()[0].attn.n_heads,
                "n_layers": nar.base.n_layers}
    requests = make_requests(len(TEXTS), ref_seconds, seed)
    refs = reference_wavs(4, ref_seconds, seed + 100)
    out = {}
    for name, steps, exported in variants:
        tag = name.removeprefix("diffusion-")
        mo = (model_overrides or {}).get(name)
        tr = smoke_train.phase_train(
            device, TRAIN_YAML, seed=seed, steps=steps, corpus=corpus, run_name=tag,
            overrides=(f"model={name}", *overrides, *([_flow(mo)] if mo else [])))
        res = {k: tr[k] for k in ("p50_step_s", "p90_step_s", "frames_per_s", "peak_bytes",
                                  "fwd_per_step", "bwd_per_step", "run_launches",
                                  "run_launches_tc", "eval_launches", "losses", "steps",
                                  "decodes", "moved")}
        if device.type == "cuda":
            check(res["run_launches_tc"] == res["run_launches"],
                  f"train {name}: {res['run_launches'] - res['run_launches_tc']} of "
                  f"{res['run_launches']} bf16 kernel-2 launches on the SIMT kernels")
        res["sites"] = tr["sites"]
        peak = res["peak_bytes"]
        log(f"train {name}: step p50 {res['p50_step_s'] * 1e3:.1f} ms, "
            f"{res['frames_per_s']:.0f} padded frames/s, peak allocated (the run's own) "
            f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}, kernel-2 launches per "
            f"step {res['fwd_per_step']} + {res['bwd_per_step']} on {smi}")
        argv = tr["argv"]
        del tr
        if device.type == "cuda":
            torch.cuda.empty_cache()

        if exported:
            e = smoke_export.export_run(argv, SMOKE_DIR / "export" / tag, steps)
            e["params"] = smoke_export.check_round_trip(argv, e["path"], steps)
            log(f"export {name}: {e['path']} in {e['seconds']:.2f} s, {e['bytes']} bytes; "
                f"{e['params']} parameters equal to the engine's EMA bit for bit (f32)")
            res["export"] = e
            first, symmap = load_model(e["path"], torch.bfloat16)
        else:
            first, symmap = get_model(name, 1024, mo or {}), default_symmap()
            init_seeded(first.denoiser, seed)

        synth = Synthesizer(first, nar, codec, symmap, device=device,
                            max_batch=len(TEXTS))
        res["served"] = serve_gaussian(synth, nar_dims, requests, f"serve {name}",
                                       repeats if exported else min(repeats, 1))
        if profile and name == "diffusion-gaussian" and device.type == "cuda":
            from .smoke import profile_batch

            res["profile"] = profile_batch(synth, requests)
        del synth
        if exported:
            with full_fp32():
                first32, _ = load_model(res["export"]["path"], torch.float32)
                nar32, _ = load_model(nar_bundle, torch.float32)
                synth32 = Synthesizer(first32, nar32, codec, symmap,
                                      device=device, max_batch=len(TEXTS), bf16=False)
                res["cohort fp32"] = smoke_serve.cohort_check(
                    synth32, refs, seed, f"serve {name} cohort, fp32", assert_equal=True)
            del synth32, first32, nar32
        del first
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[name] = res
    return out
