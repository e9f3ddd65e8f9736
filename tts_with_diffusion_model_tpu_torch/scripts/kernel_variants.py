"""Time variants of the two attention kernels' Hopper path against the
tree's own at the sites ``chip_smoke.py`` checks: the forward's ring depth
and blocks per SM (kernel 1, ``masked_attention``), the backward's ring
depth (kernel 2's dK/dV and dQ kernels, ``train_flash_attention``), and
"simt", every call on the SIMT kernels (what the tensor-core route saves).

Each variant is the tree's ``csrc/`` with one constant edited ("tree":
none), built with the flags of ``ops/_build.py`` under
``build/torch_kernels/variants/`` (one ``nvcc`` per library, all started
together) and loaded in place of the package's library.  They are built
with ``-fno-gnu-unique``: g++ otherwise binds a template's static locals
(the launchers' "shared memory attribute set" flags) once per process, so
a second copy of a library would launch its kernels above 48 KB of
shared memory without the attribute.  Every variant is held against the plain version at every
site before it is timed; a variant that does not launch at a site is
reported with its error.  Times are device ms per call (``smoke._time_ms``:
a CUDA graph replayed between events), taken twice in the order tree,
variants, variants reversed, tree.  Needs one CUDA card::

    python -m tts_with_diffusion_model_tpu_torch.scripts.kernel_variants [--out FILE]

The last line of standard output is one JSON object with every figure.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
import threading

import torch

_K1, _K2 = "masked_attention", "train_flash_attention"
_HEADER = "hopper_attention.cuh"
_TO_SIMT = (_HEADER,
            "return dtype == 1 && aligned;",
            "return false;")
#: (variant, library, [(file in csrc/, text, replacement)]); each library's
#: "tree" is its sources as they are
VARIANTS = [
    ("tree", _K1, []),
    ("simt", _K1, [_TO_SIMT]),
    ("fwd_s2", _K1, [(_HEADER, "static constexpr int kFwdStages = 3;",
                      "static constexpr int kFwdStages = 2;")]),
    # four stages do not fit a block at DH 256: it keeps three
    ("fwd_s4", _K1, [(_HEADER, "static constexpr int kFwdStages = 3;",
                      "static constexpr int kFwdStages = DH == 256 ? 3 : 4;")]),
    ("fwd_lb4", _K1, [(_HEADER, "kFwdBlocks = DH >= 128 ? 1 : 3;",
                       "kFwdBlocks = DH >= 128 ? 1 : 4;")]),
    ("tree", _K2, []),
    ("simt", _K2, [_TO_SIMT]),
    ("bwd_s2", _K2, [(_HEADER, "kBwdStages = DH == 256 ? 2 : 3;", "kBwdStages = 2;")]),
]


def build(name: str, lib: str, edits) -> tuple[str, str | None]:
    """Compile ``lib`` from an edited copy of ``csrc/`` → (library path or
    "", the error or None)."""
    from ..ops import _build

    out = _build.BUILD_DIR / "variants" / f"{lib}-{name}"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out / "csrc")
    for fname, old, new in edits:
        path = out / "csrc" / fname
        text = path.read_text()
        if text.count(old) != 1:
            return "", f"{fname}: {old!r} found {text.count(old)} times"
        path.write_text(text.replace(old, new))
    so = out / f"lib{lib}.so"
    proc = subprocess.run([_build.nvcc(), *_build.FLAGS, "-Xcompiler", "-fno-gnu-unique",
                           *_build.INCLUDES, "-o", str(so), str(out / "csrc" / f"{lib}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return "", f"nvcc {proc.returncode}: {proc.stderr[-2000:]}"
    return str(so), None


def use(lib: str, path: str):
    """Route the wrapper of ``lib`` to the library at ``path``."""
    from ..ops import _build
    from ..ops import masked_attention as k1
    from ..ops import train_flash_attention as k2

    _build._loaded[lib] = ctypes.CDLL(path)
    k1._fn, k2._fns = None, None


def sites():
    """(kernel-1 sites, kernel-2 sites): the Gaussian ones ``chip_smoke.py``
    checks (serving at B = 4, training at its batch and bucket) and the D3PM
    and NAR sites at Dh 64, each shape once."""
    from .. import smoke, smoke_gaussian, smoke_train
    from ..models.diffusion import DiffusionConfig

    serve, train = smoke_gaussian.kernel_sites(256, len(smoke.TEXTS), 32, 192)
    nar_dims = {"d_model": 1024, "n_heads": 16, "n_layers": 12}
    serve = [s for s in serve if s.count] + smoke.attention_sites(DiffusionConfig(), nar_dims,
                                                                  12, 256)
    train = [s for s in train if s.bwd]
    for yaml in (smoke_train.TRAIN_YAML, smoke_train.NAR_YAML):
        cfg, model = smoke_train.recipe(yaml)
        train += smoke_train.step_sites(model, cfg)
    seen, k1, k2 = set(), [], []
    for s in serve:
        if (s.Tq, s.Tk, s.H, s.Dh) not in seen:
            seen.add((s.Tq, s.Tk, s.H, s.Dh))
            k1.append(s)
    seen = set()
    for s in train:
        key = (s.B, s.Tq, s.Tk, s.H, s.Dh, s.causal, s.fused)
        if key not in seen:
            seen.add(key)
            k2.append(s)
    return k1, k2


def kernel1_call(site, device, seed):
    """(the timed call, its check) of kernel 1 at ``site``, B = 4, bf16."""
    from .. import smoke
    from ..ops import masked_attention as k1

    q, k, v, mask = smoke._inputs(len(smoke.TEXTS), site.Tq, site.Tk, site.H, site.Dh,
                                  torch.bfloat16, device, seed)
    ref = k1.masked_attention_plain(q, k, v, mask).float()

    def check():
        err = (k1.masked_attention(q, k, v, mask).float() - ref).abs().max().item()
        return err <= smoke.TOL[torch.bfloat16], err

    return (lambda: k1.masked_attention(q, k, v, mask)), check


def kernel2_call(site, device, seed):
    """(the timed backward, its check: o, dq, dk, dv against plain, the
    backward bit-identical across two calls) of kernel 2 at ``site``."""
    from .. import smoke, smoke_train
    from ..ops import train_flash_attention as k2

    q, k, v, km, do = smoke_train._site_inputs(site, torch.bfloat16, device, seed)
    ref = smoke_train._fwd_bwd(k2.train_flash_attention_plain, q, k, v, km, site.causal, do)
    state = {}

    def check():
        o, lse = k2._forward(q, k, v, km, site.causal)
        state["o"], state["lse"] = o, lse
        got = (o, *k2._backward(q, k, v, km, o, lse, do, site.causal))
        again = k2._backward(q, k, v, km, o, lse, do, site.causal)
        err = max(((a.float() - b.float()).abs().max() / max(1.0, b.float().abs().max().item())
                   ).item() for a, b in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got[1:], again))
        return err <= smoke.TOL[torch.bfloat16] and same, err

    def run():
        k2._backward(q, k, v, km, state["o"], state["lse"], do, site.causal)

    return run, check


def measure(lib: str, variants: dict[str, str], site_calls, device) -> list[dict]:
    """Every variant of ``lib`` (the first is the tree) at every site:
    checked, then timed twice in the order tree, variants, variants
    reversed, tree."""
    from .. import smoke

    rows = []
    order = [*variants, *reversed(list(variants))]
    for site, make in site_calls:
        row = {"site": site.name, "shape": [getattr(site, "B", len(smoke.TEXTS)), site.Tq,
                                             site.Tk, site.H, site.Dh],
               "ms": {v: [] for v in variants}, "error": {}}
        fn, check = make(site, device, 0)
        ok = {}
        for v in variants:
            use(lib, variants[v])
            try:
                good, err = check()
                torch.cuda.synchronize()
                ok[v] = good
                if not good:
                    row["error"][v] = f"disagrees with plain or differs across calls ({err:.3g})"
            except RuntimeError as e:  # a launch that failed: record, time nothing
                ok[v] = False
                row["error"][v] = str(e)
        for v in order:
            use(lib, variants[v])
            row["ms"][v].append(smoke._time_ms(fn, device, iters=5, reps=3) if ok[v] else math.nan)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    built: dict[tuple[str, str], tuple[str, str | None]] = {}
    threads = [threading.Thread(target=lambda n=n, lib=lib, e=e: built.__setitem__(
        (lib, n), build(n, lib, e))) for n, lib, e in VARIANTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = {f"{lib} {n}": e for (lib, n), (_, e) in built.items() if e}
    if failed:
        print(json.dumps({"build_failed": failed}))
        return 1
    k1_sites, k2_sites = sites()
    libs = {lib: {n: built[lib, n][0] for n, lb, _ in VARIANTS if lb == lib} for lib in (_K1, _K2)}
    with torch.no_grad():
        k1 = measure(_K1, libs[_K1], [(s, kernel1_call) for s in k1_sites], device)
    k2 = measure(_K2, libs[_K2], [(s, kernel2_call) for s in k2_sites], device)
    out = {"device": smi, "masked_attention": k1, "train_flash_attention_backward": k2}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    # the tree's own copy failing somewhere means the harness, not a variant, is at fault
    return 1 if any("tree" in r["error"] for r in k1 + k2) else 0


if __name__ == "__main__":
    sys.exit(main())
