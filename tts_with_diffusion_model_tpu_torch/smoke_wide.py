"""The wide-heads phase of the port's smoke run (``chip_smoke.py`` drives it
on the card at full width; ``tests/test_torch_smoke_wide.py`` rehearses it
on the CPU at a tiny size with the plain versions).

10. wide heads kernel — both kernels against their plain versions at head
    widths off the registry's: synthetic shapes at Dh 40, 80, 96, 128,
    136, 200 and 256 (the widths between two instantiations run at the next
    one up) and at Dh 4, 12 and 250 (not a multiple of 8: zero-padded
    copies at 8, 16 and 256), fp32 (the SIMT kernels) and bf16 (the tensor
    cores at every width), forward and dq / dk / dv, timed in bf16; and
    every site of the Dh-128 and Dh-256 paths below at its own shapes
    (timed in bf16, with its launches per batch or step); every bf16 call
    on the route ``route.tensor_core_route`` gives; an unaligned bf16 call
    of each kernel on the SIMT kernels; kernel 2's backward bit-identical
    at Dh 128 and 256;
11. train -> export -> serve wide heads — the registry models with fewer,
    wider heads at the same parameter count: ``diffusion`` (d512) with
    ``model_overrides: {n_heads: 4}`` and ``nar`` (d1024) with ``{n_heads:
    8}``, both Dh 128 (``WIDE``), and with ``{n_heads: 2}`` and ``{n_heads:
    4}``, both Dh 256 (``WIDER``), each pair written as
    ``config/gen4c/{diffusion,nar}.yml`` under ``build/smoke/<tag>/`` (the
    committed recipes plus the override); 4 train steps each through
    ``train.main`` (``TRAIN_STEPS``; kernel-2 launches per step held to the
    config: 52 + 28 and 24 + 12, all on the tensor cores, no plain call); the runs
    exported with ``--ema`` and held bit for bit to the engines' EMA; and a
    ``Synthesizer`` over each pair's bundles answering 4 requests with
    MaskGIT (376 kernel-1 launches per batch, all on the tensor cores).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from .smoke import (REPO, SMOKE_DIR, TEXTS, Site, attention_sites, check, full_fp32, log,
                    make_requests, phase_site_check, serve_and_check)
from .smoke_train import TrainSite

#: the registry recipes and the head counts that make them Dh 128
WIDE = {"diffusion": 4, "nar": 8}
#: ... and Dh 256
WIDER = {"diffusion": 2, "nar": 4}
#: the pairs' tags (directories, run and path names) by head counts
TAGS = {"wide": WIDE, "wide256": WIDER}
#: synthetic widths: between and at the tensor-core instantiations (40 at
#: 64; 80, 96 at 128; 136, 200 at 256), and widths not a multiple of 8 (4,
#: 12, 250: bf16 on zero-padded copies)
SYNTHETIC_WIDTHS = (4, 12, 40, 80, 96, 128, 136, 200, 250, 256)
#: the synthetic causal sites' widths
CAUSAL_WIDTHS = (80, 136, 256)
TRAIN_STEPS = 4


def write_configs(root: Path = SMOKE_DIR / "wide", heads_by_recipe: dict | None = None
                  ) -> dict[str, Path]:
    """``config/gen4c/<recipe>.yml`` under ``root`` for each recipe of
    ``heads_by_recipe`` (``WIDE`` by default): the committed recipe's text
    with ``model_overrides: {n_heads: N}`` appended (no file under
    ``config/`` is written)."""
    out = {}
    for name, heads in (heads_by_recipe or WIDE).items():
        src = REPO / "config" / "gen4c" / f"{name}.yml"
        dst = root / "config" / "gen4c" / f"{name}.yml"
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(src.read_text() + "\n# wide heads: the registry model with fewer, wider "
                       f"heads (same parameters)\nmodel_overrides: {{n_heads: {heads}}}\n")
        out[name] = dst
    return out


def path_sites(yamls: dict[str, Path], prompt_bucket: int = 256, tag: str = "wide"):
    """A wide pair's sites: (kernel-1 Sites of one MaskGIT batch at
    ``prompt_bucket``, kernel-2 TrainSites of one train step of each
    recipe, on the paths ``<tag> d3pm`` and ``<tag> nar``), named ``<tag>
    <site>``."""
    from . import smoke_train

    d_cfg, d_model = smoke_train.recipe(yamls["diffusion"])
    n_cfg, n_model = smoke_train.recipe(yamls["nar"])
    nar_dims = {"d_model": n_model.base.d_model, "n_heads": n_model.base.blocks()[0].attn.n_heads,
                "n_layers": n_model.base.n_layers}
    serve = [dataclasses.replace(s, name=f"{tag} {s.name}")
             for s in attention_sites(d_model.config, nar_dims, 12, prompt_bucket)]
    train = [dataclasses.replace(s, name=f"{tag} {s.name}", path=f"{tag} {path}")
             for path, (cfg, model) in (("d3pm", (d_cfg, d_model)), ("nar", (n_cfg, n_model)))
             for s in smoke_train.step_sites(model, cfg)]
    return serve, train


def synthetic_sites(widths=SYNTHETIC_WIDTHS, causal_widths=CAUSAL_WIDTHS):
    """Kernel 1 at a DiT self-attention's shape (384², 8 heads) and kernel 2
    at a D3PM training one (B = 32, 192², 8 heads) at each width, and a
    causal packed one (B = 4, 450²) at each causal width; each is one launch
    (one forward and one backward) of the path "synthetic", timed in bf16."""
    serve = [Site(f"synthetic self Dh {dh}", 384, 384, 8, dh, 1) for dh in widths]
    train = [TrainSite(f"synthetic self Dh {dh}", 32, 192, 192, 8, dh, False, 1, 1,
                       path="synthetic") for dh in widths]
    train += [TrainSite(f"synthetic causal Dh {dh}", 4, 450, 450, 8, dh, True, 1, 1,
                        path="synthetic") for dh in causal_widths]
    return serve, train


def phase_kernel_check(device, yamls: dict[str, Path], B_serve: int = 4, seed: int = 0,
                       widths=SYNTHETIC_WIDTHS, causal_widths=CAUSAL_WIDTHS,
                       wider: dict[str, Path] | None = None):
    """Phase 10 (the module docstring) → (kernel-1 results, kernel-2
    results); ``yamls`` the Dh-128 pair's configs, ``wider`` the Dh-256
    pair's (its path sites are checked too when given)."""
    from . import smoke_gaussian, smoke_train
    from .ops.route import tensor_core_route

    serve, train = path_sites(yamls)
    w_serve, w_train = path_sites(wider, tag="wide256") if wider is not None else ([], [])
    syn_serve, syn_train = synthetic_sites(widths, causal_widths)
    serve_results = [r for s in [*serve, *w_serve, *syn_serve]
                     for r in phase_site_check(device, s, B_serve, seed=seed)]
    train_results = smoke_train.phase_train_kernel_check(device, [*train, *w_train, *syn_train],
                                                         seed=seed)
    if device.type == "cuda":
        # aligned bf16: the tensor cores at every width
        off = [f"{r['site']} (Dh {r['Dh']})" for r in [*serve_results, *train_results]
               if r["dtype"] == "bfloat16" and {r["route"], r.get("route_bwd", r["route"])} != {
                   "tc" if tensor_core_route(r["Dh"], torch.bfloat16, True) else "simt"}]
        check(not off, f"bf16 wide-head sites off their route: {off}")
        with full_fp32():
            smoke_gaussian.check_unaligned(serve[2], B_serve, train[2], device, seed)
        # the DiT self-attention and the NAR's packed one of each pair, and
        # the widest synthetic site
        widest = next(s for s in syn_train if s.Dh == max(widths) and not s.causal)
        for s in (train[2], train[-1], *w_train[2:3], *w_train[-1:], widest):
            smoke_train.check_backward_determinism(s, device, seed=seed)
    return serve_results, train_results


def phase_wide(device, yamls: dict[str, Path], seed: int = 0, repeats: int = 3,
               smi: str = "n/a", steps: int = TRAIN_STEPS, overrides: dict | None = None,
               corpus=None, codec=None, ref_seconds: float = 3.0, tag: str = "wide") -> dict:
    """Phase 11 (the module docstring) for one pair (``tag``: run, export
    and log names) → the two train runs' numbers, the exports and the
    served MaskGIT batch.  ``overrides`` (per recipe, ``key=value`` items),
    ``corpus`` and ``codec`` shrink it for the CPU rehearsal."""
    from . import smoke_export, smoke_train
    from .serve import Synthesizer
    from .smoke import nar_dims_of

    device = torch.device(device)
    on_card = device.type == "cuda"
    runs, argvs = {}, {}
    for name, yaml in yamls.items():
        tr = smoke_train.phase_train(device, yaml, seed=seed, steps=steps, corpus=corpus,
                                     run_name=tag, overrides=(overrides or {}).get(name, ()))
        res = {k: tr[k] for k in ("p50_step_s", "p90_step_s", "frames_per_s", "peak_bytes",
                                  "fwd_per_step", "bwd_per_step", "run_launches",
                                  "run_launches_tc", "losses")}
        check(len({s.Dh for s in tr["sites"]}) == 1, f"train {name}: sites {tr['sites']}")
        if on_card:
            check(res["run_launches_tc"] == res["run_launches"],
                  f"train {name} {tag}: {res['run_launches'] - res['run_launches_tc']} of "
                  f"{res['run_launches']} kernel-2 launches on the SIMT kernels")
        peak = res["peak_bytes"]
        log(f"train {name} {tag} (Dh {tr['sites'][0].Dh}): step p50 {res['p50_step_s'] * 1e3:.1f} "
            f"ms, {res['frames_per_s']:.0f} padded frames/s, peak allocated (the run's own) "
            f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}, kernel-2 launches per step "
            f"{res['fwd_per_step']} + {res['bwd_per_step']} on {smi}")
        res["sites"] = tr["sites"]
        argvs[name] = tr["argv"]
        runs[name] = res
        del tr
        if on_card:
            torch.cuda.empty_cache()

    exports = {}
    for name, argv in argvs.items():
        e = smoke_export.export_run(argv, SMOKE_DIR / "export" / f"{name}_{tag}", steps)
        e["params"] = smoke_export.check_round_trip(argv, e["path"], steps)
        log(f"export {name} {tag}: {e['path']} in {e['seconds']:.2f} s, {e['bytes']} bytes; "
            f"{e['params']} parameters equal to the engine's EMA bit for bit (f32)")
        exports[name] = e
    base = Synthesizer.from_bundles(exports["diffusion"]["path"], exports["nar"]["path"], None,
                                    device=device, max_batch=len(TEXTS))
    synth = Synthesizer(base.first, base.nar, codec or base.codec, base.phone_symmap,
                        device=device, max_batch=len(TEXTS))
    nar_dims = nar_dims_of(synth.nar)
    dit = synth.first.config
    check((dit.d_model // dit.n_heads, nar_dims["d_model"] // nar_dims["n_heads"]) == (
        runs["diffusion"]["sites"][0].Dh, runs["nar"]["sites"][0].Dh),
        f"the served bundles' head widths differ from the trained runs'")
    served = serve_and_check(synth, nar_dims, make_requests(len(TEXTS), ref_seconds, seed),
                             f"serve {tag}", repeats)
    if on_card:
        check(served["launches_tc"] == served["launches"],
              f"serve {tag}: {served['launches'] - served['launches_tc']} of "
              f"{served['launches']} launches on the SIMT kernels")
    log(f"serve {tag}: MaskGIT p50 {served['p50_s'] * 1e3:.1f} ms per batch of {len(TEXTS)}, "
        f"kernel-1 launches {served['launches']} ({served['launches_tc']} on the tensor cores) "
        f"on {smi}")
    del synth, base
    if on_card:
        torch.cuda.empty_cache()
    return {"runs": runs, "exports": exports, "served": served}
