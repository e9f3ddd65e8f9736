"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--zoo] [--seed 0] [--repeats 3] [--profile]

Drives the port's paths at full width: D3PM MaskGIT serving (DiT → NAR →
EnCodec) through ``Synthesizer``; training through the train CLI's ``main``
on the gen4c recipes ``config/gen4c/diffusion.yml``, ``nar.yml`` and
``ar.yml`` (8 steps each over a seeded synthetic corpus, checkpoint and
val-loss eval at the last); then export → serve: the D3PM and NAR runs
exported by the export CLI (``--ema``), the bundles held bit for bit
against the engines' EMA, and a ``Synthesizer`` over them answering the
same requests with MaskGIT, the ancestral chain (99 denoiser calls) and the
ancestral chain at stride 3 (33); then export → serve ar: the AR run
exported and round-tripped the same way, and a ``Synthesizer`` over it and
the exported NAR decoding up to 448 tokens per request over a KV cache
(prefill on kernel 2's forward, the NAR on kernel 1), with greedy
speculative decoding held token for token against plain greedy in fp32 (the
target as its own draft, and a seeded ar-quarter draft) and compared in
bf16; then serve http: the HTTP server (``make_server`` with a ``Batcher``)
over the exported D3PM and NAR answering concurrent ``/tts`` requests, a
long-form ``/tts_stream``, an overload burst shed with 503 and a drain with
a request in flight, ``/stats`` and the kernel launches per device batch
checked, then a concurrent burst over the exported AR, and each request's
fp32 codes held identical alone and inside a cohort of 4; then train
gen4b: ``config/gen4b/diffusion.yml``, ``nar.yml`` and ``ar.yml`` (B=64) 4
steps each on the native C++ loader with an eval tick at step 4 that
decodes audio (``eval_decode_audio``: the D3PM's ancestral chain and the
NAR on kernel 1, the AR's prefill on kernel 2's forward, each eval decode's
launches checked against its sites, hyp / ref wavs and ``metrics.json``),
then a 2-step D3PM run traced with ``profile_every``; then remat policies: a gen4c
D3PM and NAR step under each ``gradient_checkpointing_policy`` with every
gradient held to whole-block recompute's; then train -> export -> serve
gaussian: both kernels held to their plain versions at the Gaussian
family's sites (head widths 32, 16 and 8; every bf16 call on the tensor
cores, unaligned views on the SIMT kernels, kernel 2's backward
bit-identical at each width), then ``model=diffusion-gaussian``
(the DiT) and ``-unet2d`` (the conv-UNet) on ``diffusion.yml`` for 8 steps,
exported with ``--ema`` and round-tripped, and ``-unet2d-ref`` at its
published widths for 2 steps from seeded weights, each served through a
``Synthesizer`` over the exported NAR (100 denoiser calls, 2488 / 788 / 84
kernel-1 launches per batch, every bf16 launch of both kernels on the
tensor cores) with fp32 codes held identical alone and in a
cohort of 4 through the ``Batcher``; then wide heads (``smoke_wide.py``):
both kernels held to their plain versions at Dh 4, 12, 40, 80, 96, 128,
136, 200, 250 and 256 (bf16 on the tensor cores, the widths off 8 on
zero-padded copies; fp32 on the SIMT kernels), forward and backward, and
the registry D3PM and NAR with fewer, wider heads (``model_overrides``
{n_heads: 4} and {n_heads: 8}, Dh 128, and {n_heads: 2} and {n_heads:
4}, Dh 256, trained 4 steps each; 52 + 28 and 24 + 12 kernel-2 launches
per step), exported and served with MaskGIT (376
kernel-1 launches per batch), every launch on the tensor cores; then codec
+ evals: a
``make_gen_corpus.py`` corpus (8 speakers × 11 utterances), ``codec.calibrate``
at 8 levels × 1024 codes × 128 dims from the seeded codec (the residual RMS
falling level by level), ``emb.qnt`` with the calibrated codec, 8 steps of
the ``codec.train`` CLI on ``diffusion.yml`` (B=32, 150-frame segments,
reloaded bit for bit), and the four evaluation entry points
(``heldout_eval`` ancestral, MaskGIT and AR, ``speaker_transfer_eval``,
``quality_gate``, ``longform_seam_eval``) on the exported D3PM, NAR and AR,
each writing the JAX records' JSON keys with every kernel launch counted
and both kernels held to their plain versions at the shapes they gave; then
parallel (``smoke_parallel.py``): the D3PM's ZeRO-1 steps and a MaskGIT
batch through ``make_sharded_generate`` in a world of one, with no process
group and in an NCCL one (bit-identical), then two ranks sharing the card
over gloo: dp=2 D3PM steps (and with ZeRO-1), tp=2 NAR steps,
``Synthesizer(mesh_tp=2)`` on the main path and dp=2 MaskGIT, each held to
one process's run of the same work, with each rank's kernel launches
counted and both kernels held to their plain versions at every per-rank
shape.
Builds every
CUDA kernel from the sources in this checkout with ``nvcc`` and counts the
wgmma (HGMMA, and HGMMA at each of the shapes 64x8x16, 64x16x16, 64x32x16,
64x64x16, 64x128x16 and 64x256x16) and TMA (UTMALDG) instructions in each
library,
holds each kernel against its plain PyTorch version at every shape these
paths give it
(printing each site's kernel/SDPA and kernel/bound ratios and its launches
on the tensor cores and on the SIMT kernels; the route each launch reports
held to ``ops/route.tensor_core_route``), checks that the
training backward is deterministic, and checks that each path launched its
kernels the number of times its config says.  Weights are drawn from
``--seed`` unless ``--zoo`` loads the committed serving bundles.  Prints
each phase's seconds as it goes; the last lines are the kernels' JSON, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.
Exits non-zero, with no result, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--zoo", action="store_true",
                        help="load zoo/diffusion, zoo/nar and zoo/encodec_24khz.npz")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--profile", action="store_true",
                        help="also trace one serving batch (MaskGIT, AR and the Gaussian DiT) "
                             "and one train step with torch.profiler and print where the time "
                             "goes")
    args = parser.parse_args()
    t_start = time.perf_counter()

    try:
        import torch
        from tts_with_diffusion_model_tpu_torch import (
            smoke,
            smoke_ar,
            smoke_export,
            smoke_gaussian,
            smoke_gen4b,
            smoke_codec,
            smoke_parallel,
            smoke_serve,
            smoke_train,
            smoke_wide,
        )
    except ImportError as e:
        print(f"chip_smoke: FAILED: cannot import the port ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAILED: torch.cuda.is_available() is false", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)

    with smoke.phase("device"):
        info = smoke.phase_device(device)
    with smoke.phase("build"):
        smoke.phase_build(device)
    from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig

    cfg = DiffusionConfig()
    nar_dims = {"d_model": 1024, "n_heads": 16, "n_layers": 12}
    with smoke.phase("kernel vs plain"):
        # 3 s references encode to 225 frames: prompt bucket 256 on the main path
        results = smoke.phase_kernel_check(
            device, cfg, nar_dims, steps=12, B=len(smoke.TEXTS),
            prompt_buckets=(128, 256, 384, 398), timed_bucket=256, seed=args.seed)
        eval_B, eval_site = smoke_train.nar_eval_site()
        eval_results = smoke.phase_site_check(device, eval_site, eval_B, seed=args.seed)
        # the AR path's NAR: text 50 + sep + prompt 256 + sep + 448 response slots
        ar_nar_results = smoke.phase_site_check(
            device, smoke_ar.nar_site(cfg.text_len, 256, smoke_ar.MAX_STEPS, nar_dims),
            len(smoke.TEXTS), seed=args.seed)
        # the gen4b eval decode's sites: the D3PM's ancestral chain at B=32
        # (the NAR's are the eval site's above, 84 launches a batch)
        decode = {f: smoke_gen4b.decode_sites(y) for f, y in smoke_gen4b.RECIPES.items()}
        d3pm_decode_results = [r for site in decode["d3pm"]["sites"] for r in smoke.phase_site_check(
            device, site, decode["d3pm"]["B"], seed=args.seed)]
        nar_decode = decode["nar"]["sites"][0]
        smoke.check((nar_decode.Tq, nar_decode.H, nar_decode.Dh, decode["nar"]["B"]) ==
                    (eval_site.Tq, eval_site.H, eval_site.Dh, eval_B),
                    "the NAR eval decode's site is not the NAR eval site")
    with smoke.phase("train kernel vs plain"):
        train_cfg, train_model = smoke_train.recipe(smoke_train.TRAIN_YAML)
        train_sites = smoke_train.step_sites(train_model, train_cfg)
        ar_sites = smoke_train.ar_prefill_sites((128, 256, 384, 398), timed_bucket=256)
        train_results = smoke_train.phase_train_kernel_check(
            device, [*train_sites, *smoke_train.packed_sites(), *ar_sites,
                     *decode["ar"]["sites"], *smoke_gen4b.train_sites()], seed=args.seed)
        smoke_train.check_backward_determinism(
            next(s for s in train_sites if s.name == "DiT self"), device, seed=args.seed)
    with smoke.phase("slice"):
        sl = smoke.phase_slice(device, "full", zoo=args.zoo, seed=args.seed,
                               repeats=args.repeats)
    if args.profile:
        with smoke.phase("profile"):
            smoke.profile_batch(sl["synth"], sl["requests"])
    smoke.check(sl["prompt_bucket"] == 256,
                f"prompt bucket {sl['prompt_bucket']} != the timed bucket 256")
    smoke.check(sl["expected"] == 376, f"expected launches {sl['expected']} != 376")
    smoke.check(sl["launches"] > 0, "the main path never launched masked_attention")
    sl_launches, sl_launches_tc = sl["launches"], sl["launches_tc"]
    del sl
    # each recipe with the kernel-2 launches per step its config gives
    # (remat: every block's forward again in the backward)
    runs, eval_runs, nar_eval_launches, argvs, runs_tc = [], [], None, {}, {}
    for name, yaml, want in (("train", smoke_train.TRAIN_YAML, (52, 28)),
                             ("train nar", smoke_train.NAR_YAML, (24, 12)),
                             ("train ar", smoke_train.AR_YAML, (24, 12))):
        with smoke.phase(name):
            tr = smoke_train.phase_train(device, yaml, seed=args.seed)
        if args.profile and name != "train ar":
            with smoke.phase(f"profile {name} step"):
                smoke_train.profile_train_step(tr["engines"], tr["cfg"])
        smoke.check((tr["fwd_per_step"], tr["bwd_per_step"]) == want,
                    f"{name}: launches per step {tr['fwd_per_step']}+{tr['bwd_per_step']} "
                    f"!= {want[0]}+{want[1]}")
        path = tr["sites"][0].path
        smoke.log(f"{name}: step p50 {tr['p50_step_s'] * 1e3:.1f} ms, "
                  f"{tr['frames_per_s']:.0f} padded frames/s, peak allocated (the run's own) "
                  f"{tr['peak_bytes'] / 2**30:.2f} GiB on {info['smi']}")
        runs.append((path, tr["fwd_per_step"], tr["bwd_per_step"], tr["run_launches"]))
        runs_tc[path] = tr["run_launches_tc"]
        argvs[path] = tr["argv"]
        if path == "nar":
            nar_eval_launches = tr["eval_launches"]
        elif path == "ar":  # the training kernel's forward under no_grad
            eval_runs.append(("ar eval", tr["eval_per_batch"], 0, tr["eval_launches"]))
        del tr
        torch.cuda.empty_cache()
    # the gen4b recipes at B=64, with the eval decode, then the remat policies
    with smoke.phase("train gen4b"):
        g4 = smoke_gen4b.phase_gen4b(device, seed=args.seed, smi=info["smi"])
    for family, r in g4.items():
        eval_runs.append((f"gen4b {family}", r["fwd_per_step"], r["bwd_per_step"],
                          r["run_launches"]))
    decode_paths = {"eval decode d3pm": dict(
        smoke.batch_totals(d3pm_decode_results),
        launches_run=sum(d["kernel1"] for d in g4["d3pm"]["decodes"]))}
    decode_paths["eval decode nar"] = smoke.path_totals(
        eval_results, [smoke.Site(eval_site.name, eval_site.Tq, eval_site.Tk, eval_site.H,
                                  eval_site.Dh, nar_decode.count)],
        sum(d["kernel1"] for d in g4["nar"]["decodes"]))
    eval_runs.append(("eval decode ar", decode["ar"]["expected"], 0,
                      sum(d["kernel2_fwd"] for d in g4["ar"]["decodes"])))
    del g4
    torch.cuda.empty_cache()
    with smoke.phase("remat policies"):
        smoke_gen4b.phase_remat(device, seed=args.seed, smi=info["smi"])
    torch.cuda.empty_cache()
    # the card-trained D3PM and NAR, exported at step 8 and served three ways
    with smoke.phase("export -> serve"):
        es = smoke_export.phase_export_serve(device, argvs["d3pm"], argvs["nar"], 8,
                                             seed=args.seed, repeats=args.repeats)
    paths = dict(decode_paths)
    for what, want in (("maskgit", 376), ("ancestral stride 1", 2464),
                       ("ancestral stride 3", 880)):
        r = es["served"][what]
        smoke.check(r["prompt_bucket"] == 256 and r["expected"] == want,
                    f"export {what}: prompt bucket {r['prompt_bucket']}, expected launches "
                    f"{r['expected']} != 256, {want}")
        smoke.log(f"export -> serve {what}: p50 {r['p50_s'] * 1e3:.1f} ms per batch of "
                  f"{len(smoke.TEXTS)} on {info['smi']}")
        if what != "maskgit":
            paths[what] = smoke.path_totals(results, r["sites"], r["launches"])
    nar_bundle = es["exports"]["nar"]["path"]
    d3pm_bundle = es["exports"]["diffusion"]["path"]
    del es
    torch.cuda.empty_cache()
    # the card-trained AR, exported at step 8 and served over the exported NAR
    with smoke.phase("export -> serve ar"):
        ar = smoke_ar.phase_export_serve_ar(device, argvs["ar"], nar_bundle, 8, seed=args.seed,
                                            repeats=args.repeats, profile=args.profile)
    served = ar["served"]
    smoke.check(served["prompt_bucket"] == 256,
                f"AR prompt bucket {served['prompt_bucket']} != the timed bucket 256")
    smoke.check(served["expected"] == {"kernel2": 12, "kernel1": 84},
                f"AR expected launches {served['expected']} != 12 and 84")
    smoke.log(f"export -> serve ar: p50 {served['p50_s'] * 1e3:.1f} ms per batch of "
              f"{len(smoke.TEXTS)}, lengths {served['lengths']}, first stage alone "
              f"{served['ar_s'] * 1e3:.1f} ms, on {info['smi']}")
    paths["ar serve"] = dict(smoke.batch_totals(ar_nar_results),
                             launches_run=served["launches"]["kernel1"])
    eval_runs += [("ar serve", 12, 0, served["launches"]["kernel2"]),
                  ("ar serve draft", 12, 0, ar["spec"]["fp32 quarter"]["kernel2"] - 12)]
    ar_bundle = ar["export"]["path"]
    del ar, served
    torch.cuda.empty_cache()
    # the HTTP server over the exported bundles: D3PM traffic, then AR
    with smoke.phase("serve http"):
        sh = smoke_serve.phase_serve_http(device, d3pm_bundle, nar_bundle, ar_bundle,
                                          seed=args.seed, smi=info["smi"])
    paths["serve http"] = dict(smoke.batch_totals(results),
                               launches_run=sh["d3pm"]["launches"]["kernel1"],
                               batches=sh["d3pm"]["stats"]["batches"])
    paths["serve http ar"] = dict(smoke.batch_totals(ar_nar_results),
                                  launches_run=sh["ar"]["launches"]["kernel1"],
                                  batches=sh["ar"]["stats"]["batches"])
    # kernel 2's server prefill runs the "ar serve" sites
    train_results += [dict(r, path="serve http ar") for r in train_results
                      if r["path"] == "ar serve"]
    eval_runs.append(("serve http ar", 12, 0, sh["ar"]["launches"]["kernel2"]))
    del sh
    torch.cuda.empty_cache()
    # the Gaussian family: its kernel sites (head widths 32, 16, 8), then
    # train -> export -> serve of each variant over the exported NAR
    with smoke.phase("gaussian kernel vs plain"):
        g_serve, g_train = smoke_gaussian.phase_kernel_check(
            device, 256, len(smoke.TEXTS), 32, 192, seed=args.seed)
    with smoke.phase("train -> export -> serve gaussian"):
        gs = smoke_gaussian.phase_gaussian(device, nar_bundle, seed=args.seed,
                                           repeats=args.repeats, smi=info["smi"],
                                           profile=args.profile)
    for name, steps_want, serve_want, pb_want in (
            ("diffusion-gaussian", (52, 28), 4 + 100 * 24 + 84, 256),
            ("diffusion-gaussian-unet2d", (11, 11), 4 + 100 * 7 + 84, 256),
            ("diffusion-gaussian-unet2d-ref", (0, 0), 84, 398)):
        r, path = gs[name], smoke_gaussian.path_name(name)
        served = r["served"]
        smoke.check((r["fwd_per_step"], r["bwd_per_step"]) == steps_want,
                    f"{name}: kernel-2 launches per step {r['fwd_per_step']}+"
                    f"{r['bwd_per_step']} != {steps_want}")
        smoke.check(served["expected"] == serve_want and served["prompt_bucket"] == pb_want,
                    f"{name}: kernel-1 launches per batch {served['expected']} at prompt "
                    f"bucket {served['prompt_bucket']} != {serve_want} at {pb_want}")
        paths[f"{path} serve"] = dict(smoke_gaussian.path_totals(
            [*g_serve, *results], served["sites"], served["launches"]),
            launches_tc_run=served["launches_tc"])
        if r["fwd_per_step"]:
            runs.append((path, r["fwd_per_step"], r["bwd_per_step"], r["run_launches"]))
            runs_tc[path] = r["run_launches_tc"]
    train_results += g_train
    del gs
    torch.cuda.empty_cache()
    # wide heads: both kernels at head widths off the registry's (bf16 on
    # the tensor cores at every width), then the registry D3PM and NAR at
    # Dh 128 and at Dh 256 through train -> export -> serve
    wide_yamls = {tag: smoke_wide.write_configs(smoke.SMOKE_DIR / tag, heads)
                  for tag, heads in smoke_wide.TAGS.items()}
    with smoke.phase("wide heads kernel vs plain"):
        w_serve, w_train = smoke_wide.phase_kernel_check(
            device, wide_yamls["wide"], len(smoke.TEXTS), seed=args.seed,
            wider=wide_yamls["wide256"])
    for tag in smoke_wide.TAGS:
        with smoke.phase(f"train -> export -> serve {tag} heads"):
            wide = smoke_wide.phase_wide(device, wide_yamls[tag], seed=args.seed,
                                         repeats=args.repeats, smi=info["smi"], tag=tag)
        for name, path, want in (("diffusion", f"{tag} d3pm", (52, 28)),
                                 ("nar", f"{tag} nar", (24, 12))):
            r = wide["runs"][name]
            smoke.check((r["fwd_per_step"], r["bwd_per_step"]) == want,
                        f"{path}: kernel-2 launches per step {r['fwd_per_step']}+"
                        f"{r['bwd_per_step']} != {want[0]}+{want[1]}")
            runs.append((path, r["fwd_per_step"], r["bwd_per_step"], r["run_launches"]))
            runs_tc[path] = r["run_launches_tc"]
        served = wide["served"]
        smoke.check(served["prompt_bucket"] == 256 and served["expected"] == 376,
                    f"serve {tag}: prompt bucket {served['prompt_bucket']}, expected launches "
                    f"{served['expected']} != 256, 376")
        paths[f"{tag} maskgit"] = dict(smoke_gaussian.path_totals(w_serve, served["sites"],
                                                                  served["launches"]),
                                       launches_tc_run=served["launches_tc"])
        del wide, served
        torch.cuda.empty_cache()
    train_results += w_train
    # the codec's bootstrap and the four evaluations over the exported bundles
    with smoke.phase("codec + evals"):
        ce = smoke_codec.phase_codec_evals(
            device, {"d3pm": d3pm_bundle, "nar": nar_bundle, "ar": ar_bundle}, seed=args.seed)
    tr = ce["train"]
    ce_kernel1 = ce["kernels"]["kernel1"]
    smoke.log(f"codec train: step p50 {tr['p50_step_s'] * 1e3:.1f} ms, p90 "
              f"{tr['p90_step_s'] * 1e3:.1f} ms, peak allocated (the run's own) "
              f"{tr['peak_bytes'] / 2**30:.2f} GiB on {info['smi']}")
    smoke.log("codec + evals seconds: " + ", ".join(
        f"{name} {r['seconds']:.2f}" for name, r in ce["evals"]["runs"].items())
        + f" on {info['smi']}")
    paths.update(ce["kernels"]["paths1"])
    train_results += ce["kernels"]["kernel2"]
    eval_runs += ce["kernels"]["runs2"]
    del ce
    torch.cuda.empty_cache()
    # dp x tp: a world of one over NCCL, then two ranks sharing the card
    with smoke.phase("parallel"):
        par = smoke_parallel.phase_parallel(device, seed=args.seed, smi=info["smi"])
    paths.update(par["paths1"])
    train_results += par["kernel2"]
    eval_runs += par["runs2"]
    kernels = [smoke.kernel_summary(results, sl_launches, eval_results, nar_eval_launches,
                                    paths, checked=[*ar_nar_results, *d3pm_decode_results,
                                                    *g_serve, *w_serve, *ce_kernel1,
                                                    *par["kernel1"]],
                                    launches_tc=sl_launches_tc),
               smoke_train.train_kernel_summary(train_results, runs, eval_runs, runs_tc)]
    smoke.log(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s "
              f"on {info['kind']} ({info['smi']})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                             "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
