"""The export → serve phase of the port's smoke run (``chip_smoke.py``
drives it on the card after the train phases; the CPU tests rehearse it at
a tiny size with the plain versions).

7. export → serve — the D3PM's and the NAR's train runs exported by the
   export CLI's ``main`` (``--ema`` at the runs' last step), each bundle
   reloaded into a fresh module and held bit for bit against the engine's
   EMA, then one ``Synthesizer`` over the two bundles answering the same
   requests with MaskGIT, the ancestral chain and the ancestral chain at
   stride 3 (``smoke.serve_and_check`` for each).
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path

import torch

from .smoke import SMOKE_DIR, TEXTS, check, log, make_requests, nar_dims_of, serve_and_check

#: the first stage's samplers the phase serves with: (decode, stride)
DECODES = (("maskgit", 1), ("ancestral", 1), ("ancestral", 3))


def export_run(argv: list[str], dest: Path, step: int) -> dict:
    """The export CLI on a train run (``argv``: the run's ``key=value``
    items) at checkpoint ``step`` with ``--ema`` → seconds and bundle bytes."""
    from . import export

    shutil.rmtree(dest, ignore_errors=True)
    t0 = time.perf_counter()
    export.main([*argv, f"restore_step={step}", "--ema", str(dest)])
    secs = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in dest.iterdir())
    return {"path": dest, "seconds": secs, "bytes": nbytes}


def check_round_trip(argv: list[str], dest: Path, step: int) -> int:
    """Reload the bundle into a freshly built module and hold every
    parameter bit for bit against the run's EMA at ``step`` (the
    checkpoint's, which the train phase held equal to the trained
    engine's) → the number of parameters compared."""
    from . import convert
    from .bundle import load_bundle
    from .config import Config
    from .serve import build_model
    from .train.train import load_engines

    cfg = Config.from_cli([*argv, f"restore_step={step}"])
    engine = load_engines(cfg)["model"]
    ema = engine.ema_state_dict()
    flat, meta, _, _ = load_bundle(dest)
    check(meta["weights"] == "ema" and meta["step"] == step,
          f"{dest}: model.json says {meta['weights']} weights at step {meta['step']}")
    module = build_model(meta, torch.float32)
    target = getattr(module, "denoiser", module)
    prefix = "denoiser." if target is not module else ""
    convert.jax_params_to_torch(flat, target)
    n = 0
    for name, p in target.named_parameters():
        e = ema[prefix + name]
        check(p.dtype == e.dtype == torch.float32 and torch.equal(p, e.cpu()),
              f"{dest}: {name} differs from the engine's EMA")
        n += 1
    check(n == len(ema), f"{dest}: {n} parameters compared, the EMA has {len(ema)}")
    del engine, ema, module
    return n


def phase_export_serve(device, d3pm_argv: list[str], nar_argv: list[str], step: int,
                       seed: int = 0, repeats: int = 3, ref_seconds: float = 3.0,
                       codec=None) -> dict:
    """Export both runs, check the round trips, and serve ``TEXTS`` through
    the exported bundles with each sampler of ``DECODES``: the codec is
    ``from_bundles``'s with weights drawn from seed 0, or ``codec`` (the
    CPU rehearsal's small one)."""
    from .serve import Synthesizer

    exports = {}
    for name, argv in (("diffusion", d3pm_argv), ("nar", nar_argv)):
        e = export_run(argv, SMOKE_DIR / "export" / name, step)
        e["params"] = check_round_trip(argv, e["path"], step)
        log(f"export {name}: {e['path']} in {e['seconds']:.2f} s, {e['bytes']} bytes; "
            f"{e['params']} parameters equal to the engine's EMA bit for bit (f32)")
        exports[name] = e
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    base = Synthesizer.from_bundles(exports["diffusion"]["path"], exports["nar"]["path"],
                                    None, device=device, max_batch=len(TEXTS))
    log(f"export: Synthesizer over the exported bundles on {device} in "
        f"{time.perf_counter() - t0:.2f} s")
    nar_dims = nar_dims_of(base.nar)
    requests = make_requests(len(TEXTS), ref_seconds, seed)
    served = {}
    for decode, stride in DECODES:
        synth = Synthesizer(base.first, base.nar, codec or base.codec, base.phone_symmap,
                            device=device, max_batch=len(TEXTS), decode=decode, stride=stride)
        r = serve_and_check(synth, nar_dims, requests, "export", repeats)
        served[r["decode"]] = r
    return {"exports": exports, "served": served}
