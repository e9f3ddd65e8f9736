"""Phases of the port's smoke run (``chip_smoke.py`` at the repository root
drives them on the card at full width; the CPU tests rehearse them at a tiny
size with the plain versions).

1. device  — the card's name, count, and ``nvidia-smi`` name / power limit;
2. build   — every CUDA kernel, through ``ops/_build.py``;
3. kernel  — each kernel against its plain version at every shape the main
             path gives it, fp32 and bf16, with times beside the plain
             version's and a PyTorch library call's;
4. slice   — a ``Synthesizer`` answering a batch of requests, with the
             kernels' launch counts read around it (``serve_and_check``,
             which the export → serve phase of ``smoke_export.py`` also runs).

Every phase prints one line with its seconds when it ends; a failing check
raises ``SmokeError``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .ops import masked_attention as attn_ops

REPO = Path(__file__).resolve().parents[1]
SMOKE_DIR = REPO / "build" / "smoke"

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: kernel-vs-plain bounds on max |error|: fp32 sums in another order than
#: the plain path; bf16 rounds p and the output to 8 bits of mantissa
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REPLACES = "tts_with_diffusion_model_tpu/ops/flash_attention.py:47"
TEXTS = (
    "the quick brown fox jumps over the lazy dog",
    "she said that we would go there in the morning",
    "how are you doing today my friend",
    "this is a test of the voice cloning system",
)


class SmokeError(RuntimeError):
    pass


def log(msg: str):
    print(msg, flush=True)


class phase:
    """Context manager printing ``[phase] <name>: <seconds> s`` at its end."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"[phase] {self.name} ...")
        return self

    def __exit__(self, exc_type, exc, tb):
        secs = time.perf_counter() - self.t0
        state = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"[phase] {self.name}: {state} in {secs:.2f} s")
        return False


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeError(msg)


# ---------------- 1. device ----------------

def nvidia_smi_line() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def phase_device(device: torch.device) -> dict:
    if device.type != "cuda":
        log("device: cpu (plain versions; no device times)")
        return {"platform": "cpu", "kind": "cpu", "count": 0, "smi": "n/a"}
    if not torch.cuda.is_available():
        raise SmokeError("torch.cuda.is_available() is false")
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "smi": nvidia_smi_line()}
    log(f"device: {info['kind']} x{info['count']}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log(info["smi"])
    return info


# ---------------- 2. build ----------------

def phase_build(device: torch.device) -> float:
    if device.type != "cuda":
        log("build: skipped on cpu (no nvcc needed for the plain versions)")
        return 0.0
    from .ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all(log=log)
    secs = time.perf_counter() - t0
    log(f"build: {len(libs)} librar{'y' if len(libs) == 1 else 'ies'} in {secs:.2f} s via nvcc + ctypes")
    # one cuobjdump per library, all started together (each takes seconds)
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        sass = dict(zip(sorted(libs), pool.map(_build.sass_counts,
                                               [libs[n] for n in sorted(libs)])))
    for name, path in sorted(libs.items()):
        counts = sass[name]
        if isinstance(counts, str):
            log(f"sass: {path.name}: {counts}")
            continue
        log(f"sass: {path.name}: " + ", ".join(f"{op} {n}" for op, n in counts.items()))
        check(all(counts.values()),
              f"{path.name}: no {[op for op, n in counts.items() if not n]} instruction: "
              "the bf16 path does not run on wgmma fed by TMA")
    return secs


# ---------------- 3. kernel against plain ----------------

@dataclasses.dataclass
class Site:
    """One attention call site of the main path, and its launches per batch."""
    name: str
    Tq: int
    Tk: int
    H: int
    Dh: int
    count: int


def attention_sites(dit_cfg, nar_dims: dict, steps: int, prompt_bucket: int) -> list[Site]:
    """The masked-attention sites one ``Synthesizer`` batch call runs, with
    their launch counts (sum = 4 + steps·n_layers·3 + 7·nar_layers)."""
    H, Dh = dit_cfg.n_heads, dit_cfg.d_model // dit_cfg.n_heads
    Tr = dit_cfg.serving_resp_bucket
    L = dit_cfg.n_layers
    nH = nar_dims["n_heads"]
    nDh = nar_dims["d_model"] // nH
    packed = dit_cfg.text_len + 1 + prompt_bucket + 1 + dit_cfg.gen_len
    return [
        Site("text tower self", dit_cfg.text_len, dit_cfg.text_len, H, Dh, 2),
        Site("prompt tower self", prompt_bucket, prompt_bucket, H, Dh, 2),
        Site("DiT self", Tr, Tr, H, Dh, steps * L),
        Site("DiT text cross", Tr, dit_cfg.text_len, H, Dh, steps * L),
        Site("DiT prompt cross", Tr, prompt_bucket, H, Dh, steps * L),
        Site("NAR packed self", packed, packed, nH, nDh, 7 * nar_dims["n_layers"]),
    ]


def expected_launches(sites: list[Site]) -> int:
    return sum(s.count for s in sites)


def _inputs(B, Tq, Tk, H, Dh, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, Dh, generator=g).to(dtype).to(device) for T in (Tq, Tk, Tk))
    mask = torch.ones(B, Tk)
    if B > 1:  # ragged: a valid prefix
        mask[1, int(torch.randint(1, Tk + 1, (1,), generator=g)):] = 0
    if B > 2:  # holes
        mask[2] = (torch.rand(Tk, generator=g) > 0.3).float()
        mask[2, 0] = 1
    if B > 3:  # every key masked: the row must stay finite
        mask[3] = 0
    return q, k, v, mask.to(device)


def _time_ms(fn, device, iters: int = 20, reps: int = 5) -> float | None:
    """Device ms per call: ``iters`` calls captured in a CUDA graph, the graph
    replayed ``reps`` times between CUDA events (host launch cost excluded;
    inputs stay in L2, as they do for the caller that just computed them)."""
    if device.type != "cuda":
        return None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _eager_ms(fn, device, iters: int = 50, warmup: int = 5) -> float | None:
    """Wall ms per call of an eager loop (host launch cost included)."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def work(kv_mask, Tq: int, H: int, causal: bool = False) -> tuple[int, int]:
    """(score pairs, value pairs) this key mask needs, over every query row
    and head: a visible (query, key) pair costs a q·k and a p·v product; a
    row whose keys are all masked costs no q·k but averages all Tk values."""
    from .ops.train_flash_attention import visible

    vis = visible(kv_mask, Tq, causal).expand(-1, -1, Tq, -1)
    per_row = vis.sum(dim=-1)
    qk = int(per_row.sum())
    pv = qk + int((per_row == 0).sum()) * kv_mask.shape[1]
    return qk * H, pv * H


def bound_ms(B, Tq, Tk, H, Dh, dtype, pairs: tuple[int, int] | None = None) -> tuple[float, str]:
    """Least time on an H100 SXM: each input read once, the output written
    once, against the products at the type's peak: 2·Dh operations per
    (score pair + value pair), ``pairs`` from ``work`` (by default every
    pair: 4·B·H·Tq·Tk·Dh)."""
    el = torch.finfo(dtype).bits // 8
    nbytes = (B * Tq * H * Dh * 2 + 2 * B * Tk * H * Dh) * el + B * Tk * 4
    qk, pv = pairs if pairs is not None else (B * H * Tq * Tk,) * 2
    flops = 2 * Dh * (qk + pv)
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def unaligned(t):
    """A copy of the (B, T, H, Dh) tensor ``t`` whose time stride is H·Dh + 4
    elements, not a multiple of 8: at a Dh that is a multiple of 8 the
    libraries then take the SIMT route (``ops/route.tma_aligned``), on the
    same values."""
    B, T, H, Dh = t.shape
    buf = torch.zeros(B, T, H * Dh + 4, dtype=t.dtype, device=t.device)
    view = buf[..., :H * Dh].unflatten(-1, (H, Dh))
    view.copy_(t)
    return view


def check_route(what: str, launched: int, Dh: int, dtype, tensors):
    """The route a launch reported (``launched``, 1 = tensor cores) against
    ``route.tensor_core_route`` on the same tensors."""
    from .ops.route import tensor_core_route, tma_aligned

    want = int(tensor_core_route(Dh, dtype, tma_aligned(*tensors)))
    check(launched == want, f"{what}: the launch took route {launched}, tensor_core_route "
                            f"{want} (1 = tensor cores)")
    return "tc" if want else "simt"


def check_site(site: Site, B: int, dtype, device, seed: int, time_it: bool) -> dict:
    """Kernel (the wrapper) against the plain version on the same inputs, its
    route held to ``route.tensor_core_route``; then (``time_it``) the device
    time of the kernel, the plain version and SDPA, and the kernel's eager
    wall time per call."""
    q, k, v, mask = _inputs(B, site.Tq, site.Tk, site.H, site.Dh, dtype, device, seed)
    fn = attn_ops.masked_attention
    before = fn.launches, fn.launches_tc
    got = fn(q, k, v, mask)
    ref = attn_ops.masked_attention_plain(q, k, v, mask)
    if device.type == "cuda":
        torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    res = {"site": site.name, "B": B, "Tq": site.Tq, "Tk": site.Tk, "H": site.H,
           "Dh": site.Dh, "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "finite": finite}
    check(finite, f"{site.name} {dtype}: non-finite kernel output")
    check(err <= TOL[dtype], f"{site.name} {dtype}: max abs err {err:.3g} > {TOL[dtype]:g}")
    if device.type == "cuda":
        res["route"] = check_route(f"masked_attention {site.name} {dtype}",
                                   fn.launches_tc - before[1], site.Dh, dtype, (q, k, v, got))
    if time_it and device.type == "cuda":
        res["ms"] = _time_ms(lambda: attn_ops.masked_attention(q, k, v, mask), device)
        res["eager_ms"] = _eager_ms(lambda: attn_ops.masked_attention(q, k, v, mask), device)
        res["plain_ms"] = _time_ms(lambda: attn_ops.masked_attention_plain(q, k, v, mask), device)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bias = torch.where(mask > 0, 0.0, attn_ops.NEG_INF).to(dtype)[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["library_ms"] = _time_ms(lambda: sdpa(qt, kt, vt, attn_mask=bias), device)
        res["bound_ms"], res["bound_by"] = bound_ms(B, site.Tq, site.Tk, site.H, site.Dh, dtype,
                                                    work(mask, site.Tq, site.H))
        res["vs_library"] = res["ms"] / res["library_ms"]
        res["vs_bound"] = res["ms"] / res["bound_ms"]
    # the comparison's own launches are not the main path's
    fn.launches, fn.launches_tc = before
    return res


@contextlib.contextmanager
def full_fp32():
    """Matmuls and cuDNN convolutions in full fp32 inside the block (the
    plain version is the reference; TF32 would round its products)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _check_and_log(site: Site, B: int, dtype, device, seed: int, timed: bool,
                   count: int) -> dict:
    r = check_site(site, B, dtype, device, seed, time_it=timed)
    r["count"] = count
    log(json.dumps(r))
    if "vs_library" in r:
        tc = count if r["route"] == "tc" else 0
        log(f"ratio: masked_attention {r['site']} {r['Tq']}x{r['Tk']} (B={B}, Dh {r['Dh']}): "
            f"kernel/SDPA {r['vs_library']:.3f}, kernel/bound {r['vs_bound']:.2f}; launches "
            f"per batch {count}: {tc} tensor cores, {count - tc} SIMT")
    return r


def phase_kernel_check(device, dit_cfg, nar_dims: dict, steps: int, B: int,
                       prompt_buckets, timed_bucket: int, seed: int = 0) -> list[dict]:
    """Every site at every prompt bucket, fp32 and bf16; times at the main
    path's bucket in bf16."""
    with full_fp32():
        results, seen = [], set()
        for pb in prompt_buckets:
            for site in attention_sites(dit_cfg, nar_dims, steps, pb):
                key = (site.Tq, site.Tk, site.H, site.Dh)
                if key in seen and pb != timed_bucket:
                    continue
                seen.add(key)
                for dtype in (torch.float32, torch.bfloat16):
                    timed = pb == timed_bucket and dtype == torch.bfloat16
                    results.append(_check_and_log(site, B, dtype, device, seed, timed,
                                                  site.count if pb == timed_bucket else 0))
    return results


def phase_site_check(device, site: Site, B: int, seed: int = 0) -> list[dict]:
    """One site at batch ``B``, fp32 and bf16, timed in bf16."""
    with full_fp32():
        return [_check_and_log(site, B, dtype, device, seed, dtype == torch.bfloat16, site.count)
                for dtype in (torch.float32, torch.bfloat16)]


def batch_totals(results: list[dict]) -> dict:
    """Σ launches × time over the timed sites of one batch: the kernel, the
    plain version, SDPA and the bound (with what bounds most of it)."""
    timed = [r for r in results if "ms" in r and r["count"]]

    def total(key):
        if not timed or any(r.get(key) is None for r in timed):
            return None
        return sum(r[key] * r["count"] for r in timed)

    bytes_ms = sum(r["bound_ms"] * r["count"] for r in timed if r["bound_by"] == "bytes")
    ops_ms = sum(r["bound_ms"] * r["count"] for r in timed if r["bound_by"] == "operations")
    return {"launches": sum(r["count"] for r in timed),
            "launches_tc": sum(r["count"] for r in timed if r.get("route") == "tc"),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": total("library_ms")}


def path_totals(results: list[dict], sites: list[Site], launches_run: int) -> dict:
    """Per-batch sums of a path that runs the sites timed in ``results`` at
    other counts (``sites``, matched by name): the ancestral chain runs
    MaskGIT's sites, its DiT sites once per process step."""
    count = {s.name: s.count for s in sites}
    timed = [dict(r, count=count[r["site"]]) for r in results if "ms" in r and r["count"]]
    return dict(batch_totals(timed), launches_run=launches_run)


def kernel_summary(results: list[dict], launches: int, eval_results=None,
                   eval_launches: int | None = None, paths: dict | None = None,
                   checked=(), launches_tc: int | None = None) -> dict:
    """The kernel's line: per-batch sums over the main path's timed sites;
    with ``eval_results``, also per NAR val-loss eval batch, and the other
    ``paths`` (``path_totals``), under ``paths``; the errors of the sites in
    ``checked`` count in ``max_abs_err`` too.  ``launches_tc``: of the main
    path's ``launches``, those on the tensor cores."""
    serving = batch_totals(results)
    line = {
        "name": "masked_attention",
        "route": "cuda",
        "source": "tts_with_diffusion_model_tpu_torch/csrc/masked_attention.cu",
        "replaces": REPLACES,
        "launches": launches,
        "launches_tc": launches_tc,
        "max_abs_err": max(r["max_abs_err"] for r in [*results, *(eval_results or []), *checked]
                           if r["dtype"] == "bfloat16"),
        **{k: serving[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "per": "one batch call of the main path: sum over its attention sites of launches x time",
    }
    if eval_results is not None:
        line["paths"] = {"serving": dict(serving, launches_run=launches),
                         "nar eval": dict(batch_totals(eval_results),
                                          launches_run=eval_launches)}
    if paths:
        line.setdefault("paths", {}).update(paths)
    return line


# ---------------- 4. the slice ----------------

def default_symmap() -> dict[str, int]:
    """Phone symmap over every phone the built-in g2p can emit (id 0 = pad)."""
    from .text import g2p

    phones = {"_"}
    for ph in g2p.LEXICON.values():
        phones.update(ph)
    for _, ph in g2p._L2S_RULES:
        phones.update(ph)
    return {p: i + 1 for i, p in enumerate(sorted(phones))}


def tiny_models(dtype=torch.float32):
    """A few layers at narrow widths, for CPU rehearsals and tests."""
    from .codec.encodec import EncodecModel
    from .models.diffusion import DiffusionConfig, DiffusionModel
    from .models.nar import NAR

    cfg = DiffusionConfig(d_model=32, n_heads=2, n_layers=2, resp_len=64, text_len=50,
                          prom_len=64, gen_len=40, timesteps=20)
    nar_dims = dict(d_model=32, n_heads=2, n_layers=2)
    return (DiffusionModel(cfg, dtype=dtype), NAR(1024, dtype=dtype, **nar_dims), nar_dims,
            EncodecModel(dimension=16, n_filters=4, n_q_total=8))


def full_models(dtype=torch.bfloat16):
    """The registry defaults: DiT d512/8 heads/8 blocks, NAR d1024/16/12,
    the 24 kHz EnCodec."""
    from .codec.encodec import EncodecModel
    from .models.diffusion import DiffusionConfig, DiffusionModel
    from .models.nar import NAR

    nar_dims = dict(d_model=1024, n_heads=16, n_layers=12)
    return (DiffusionModel(DiffusionConfig(), dtype=dtype), NAR(1024, dtype=dtype, **nar_dims),
            nar_dims, EncodecModel())


def reference_wavs(n: int, seconds: float, seed: int) -> list[Path]:
    """Synthetic speech-like reference wavs (harmonics + noise) from a seed,
    written under ``build/smoke/``."""
    from .audio.wavio import write_wav
    from .codec.encodec import SAMPLE_RATE

    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    paths = []
    for i in range(n):
        f0 = rs.uniform(90, 220)
        wav = sum(rs.uniform(0.05, 0.2) * np.sin(2 * math.pi * f0 * h * t + rs.uniform(0, 6.3))
                  for h in range(1, 6))
        wav = wav * (0.6 + 0.4 * np.sin(2 * math.pi * 3 * t)) + 0.01 * rs.randn(len(t))
        p = SMOKE_DIR / f"ref_{seed}_{i}.wav"
        write_wav(p, np.clip(wav, -1, 1).astype(np.float32), SAMPLE_RATE)
        paths.append(p)
    return paths


def build_synthesizer(device, size: str, zoo: bool, seed: int, max_batch: int = 4):
    """A ``Synthesizer`` at ``size`` ("full" or "tiny") from seeded weights,
    or from the committed zoo bundles (full size only)."""
    from .codec.encodec import Codec
    from .convert import init_seeded
    from .serve import Synthesizer

    if zoo:
        if size != "full":
            raise ValueError("--zoo needs the full size")
        synth = Synthesizer.from_bundles(REPO / "zoo/diffusion", REPO / "zoo/nar",
                                         REPO / "zoo/encodec_24khz.npz", device=device,
                                         max_batch=max_batch)
        return synth, nar_dims_of(synth.nar)
    first, nar, nar_dims, codec_model = full_models() if size == "full" else tiny_models()
    init_seeded(first.denoiser, seed)
    init_seeded(nar, seed + 1)
    init_seeded(codec_model, seed + 2)
    codec = Codec(codec_model, device)
    synth = Synthesizer(first, nar, codec, default_symmap(), device=device, max_batch=max_batch,
                        bf16=size == "full")
    return synth, nar_dims


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def nar_dims_of(nar) -> dict:
    base = nar.base
    return {"d_model": base.d_model, "n_heads": base.blocks()[0].attn.n_heads,
            "n_layers": base.n_layers}


def make_requests(n: int, ref_seconds: float, seed: int) -> list[tuple]:
    """(text, reference wav, seed) for ``n`` requests of ``TEXTS``."""
    refs = reference_wavs(n, ref_seconds, seed)
    return [(text, ref, seed + i) for i, (text, ref) in enumerate(zip(TEXTS, refs))]


def phase_slice(device, size: str = "full", zoo: bool = False, seed: int = 0,
                repeats: int = 3, ref_seconds: float = 3.0) -> dict:
    """Build the Synthesizer and serve ``TEXTS`` through it (``serve_and_check``)."""
    t0 = time.perf_counter()
    synth, nar_dims = build_synthesizer(device, size, zoo, seed)
    log(f"slice: {size} Synthesizer on {device} built in {time.perf_counter() - t0:.2f} s "
        f"({'zoo bundles' if zoo else 'seeded weights'})")
    requests = make_requests(len(TEXTS), ref_seconds, seed)
    out = serve_and_check(synth, nar_dims, requests, "slice", repeats)
    return dict(out, nar_dims=nar_dims, dit_cfg=synth.first.config, synth=synth,
                requests=requests)


def serve_and_check(synth, nar_dims: dict, requests, label: str, repeats: int = 3) -> dict:
    """Answer one batch of ``requests`` with the kernel counts set to 0 just
    before and read just after, and check the launches against the count
    the sites give, the codes and the wavs; then the same seeds again, one
    denoiser call kernel-vs-plain, and the p50 of ``repeats`` more batches."""
    device = synth.device
    prepared = [synth.prepare(t, r) for t, r, _ in requests]
    seeds = [s for _, _, s in requests]
    pb = synth.prompt_bucket(prepared)
    calls = synth.denoiser_calls
    sites = attention_sites(synth.first.config, nar_dims, calls, pb)
    expected = expected_launches(sites)
    fn = attn_ops.masked_attention
    what = synth.decode + (f" stride {synth.stride}" if synth.decode == "ancestral" else "")

    fn.launches, fn.launches_tc, fn.plain_calls = 0, 0, 0
    _sync(device)
    t1 = time.perf_counter()
    codes, wavs = synth._device_batch(prepared, seeds, want_wav=True)
    _sync(device)
    first_s = time.perf_counter() - t1
    launches, launches_tc, plain_calls = fn.launches, fn.launches_tc, fn.plain_calls
    counted = launches if device.type == "cuda" else plain_calls
    log(f"{label}: {what} ({calls} denoiser calls), first batch of {len(requests)} in "
        f"{first_s:.3f} s; prompt bucket {pb}; kernel launches {launches} ({launches_tc} on "
        f"the tensor cores), plain calls {plain_calls}, expected {expected}")
    check(counted == expected, f"{label} {what}: attention calls {counted} != expected {expected}")
    if device.type == "cuda":
        check(plain_calls == 0, f"{label} {what}: the plain path ran on the card")
    gl = synth.gen_len
    for i, (c, w) in enumerate(zip(codes, wavs)):
        check(c.shape == (gl, 8), f"request {i}: codes {c.shape} != {(gl, 8)}")
        check(int(c.min()) >= 0 and int(c.max()) < 1024, f"request {i}: codes outside [0, 1024)")
        check(w.shape == (gl * 320,), f"request {i}: wav {w.shape} != {(gl * 320,)}")
        check(bool(np.isfinite(w).all()), f"request {i}: non-finite samples")

    codes2, _ = synth._device_batch(prepared, seeds, want_wav=True)
    check(all(np.array_equal(a, b) for a, b in zip(codes, codes2)),
          f"{label} {what}: a second run with the same seeds gave other codes")

    den_err, den_scale = denoiser_kernel_vs_plain(synth, prepared, seeds)
    log(f"{label}: denoiser logits kernel vs plain max abs err {den_err:.4g} "
        f"(max |logit| {den_scale:.4g})")
    check(den_err <= TOL[torch.bfloat16] * max(1.0, den_scale),
          f"denoiser kernel vs plain: {den_err:.4g} > {TOL[torch.bfloat16]} x max(1, {den_scale:.4g})")

    times = []
    for _ in range(repeats):
        _sync(device)
        t2 = time.perf_counter()
        synth.synthesize_batch(requests)
        _sync(device)
        times.append(time.perf_counter() - t2)
    p50 = float(np.median(times))
    log(f"{label}: {what} synthesize_batch of {len(requests)} p50 {p50 * 1e3:.1f} ms over "
        f"{repeats} ({'host clock around synchronised work' if device.type == 'cuda' else 'cpu, not a device time'})")
    return {"launches": launches, "launches_tc": launches_tc, "expected": expected,
            "p50_s": p50, "first_s": first_s,
            "times_s": times, "prompt_bucket": pb, "sites": sites, "denoiser_err": den_err,
            "steps": calls, "codes": codes, "decode": what}


def profile_call(fn, what: str, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (after the run's warm
    calls): wall ms, summed device kernel ms, the device's idle share of the
    wall time, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side ranges of record_function annotations (Optimizer.step)
    # span kernels counted on their own, so they are left out
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.device_time / 1e3
        acc[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    out = {"what": what, "wall_ms": wall_ms, "device_kernel_ms": busy_ms,
           "kernels": len(kernels), "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top": [{"name": n[:80], "ms": v[0], "calls": v[1]} for n, v in ranked]}
    log("profile: " + json.dumps(out))
    return out


def profile_batch(synth, requests) -> dict:
    """One ``synthesize_batch`` under the profiler."""
    return profile_call(lambda: synth.synthesize_batch(requests), "serving batch")


@torch.no_grad()
def denoiser_kernel_vs_plain(synth, prepared, seeds) -> tuple[float, float]:
    """One denoiser call (towers, cross K/V and a step at the first MaskGIT
    timestep) with the kernel, then with the plain version on the same
    device → (max |Δ logits|, max |logits|)."""
    from unittest import mock

    dev = synth.device
    pb = synth.prompt_bucket(prepared)

    def stack(key):
        return torch.as_tensor(np.concatenate([r[key] for r in prepared]), device=dev)

    text, tm = stack("text"), stack("text_mask")
    proms, pm = stack("proms")[:, :pb], stack("prom_mask")[:, :pb].contiguous()
    den, c = synth.first.denoiser, synth.first.config
    B, Tr = text.shape[0], synth.resp_bucket
    rm = (torch.arange(Tr, device=dev)[None] < c.gen_len).float().expand(B, Tr).contiguous()
    x = torch.where(rm > 0, synth.first.d3pm.absorbing_state, 0).long()
    t = torch.full((B,), c.timesteps - 1, dtype=torch.long, device=dev)

    def run():
        tc, sc = den.conds(text, tm, proms, pm)
        return den.denoise_with_kv(x, rm, t, den.cond_kv(tc, sc), tm, pm).float()

    fn = attn_ops.masked_attention
    before = fn.launches, fn.launches_tc
    got = run()
    with mock.patch.object(attn_ops, "masked_attention", attn_ops.masked_attention_plain):
        ref = run()
    fn.launches, fn.launches_tc = before
    return (got - ref).abs().max().item(), ref.abs().max().item()
