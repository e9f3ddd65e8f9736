"""The HTTP serving phase of the port's smoke run (``chip_smoke.py`` drives
it on the card after "export -> serve ar"; the CPU tests rehearse it at a
tiny size with the plain versions).

9. serve http — ``make_server`` on 127.0.0.1 at an ephemeral port, in a
   thread, over the exported D3PM (MaskGIT) and NAR in bf16: ``max_batch``
   4, a ``Batcher`` window of 10 ms, ``max_pending`` 8, after ``warmup``
   (the first request is timed before and after it).  Client threads send
   8 concurrent ``/tts`` requests over 3 reference wavs whose prompt codes
   are not cached (so the encodes run beside device batches; the cached
   codes are then held equal to a serial encode), one ``/tts_stream``
   long-form request of 3 segments (its chunks timed as they arrive and
   held against ``synthesize_stream``), and a burst over ``max_pending``
   that must be shed with 503.  ``/stats`` must agree with what the
   clients saw, and kernel 1 must have launched once per attention site of
   every device batch (376 per D3PM batch) with no plain call on the card.
   Then ``drain()`` with a request in flight, which must complete.  Then
   the same concurrent burst over the exported AR at ``max_ar_steps`` 448
   (12 kernel-2 forwards and 84 kernel-1 launches per batch).  Last, the
   cohort check through the ``Batcher``: each of 4 requests alone and
   inside one cohort of 4, whose codes must be identical in fp32 (TF32
   off); in bf16 the share of identical codes is printed.

The phase alone, after the kernels' build, over full-width bundles written
from seeded weights (no training)::

    python -m tts_with_diffusion_model_tpu_torch.smoke_serve [--seed 0]
"""

from __future__ import annotations

import http.client
import io
import json
import socket
import threading
import time
import wave
from unittest import mock

import numpy as np
import torch

from . import serve
from .smoke import (
    SMOKE_DIR,
    TEXTS,
    _sync,
    attention_sites,
    check,
    full_fp32,
    log,
    nar_dims_of,
    phase,
    phase_build,
    phase_device,
    reference_wavs,
)
from .smoke_ar import _counts, _reset_counts

WINDOW_MS = 10.0
MAX_PENDING = 8
MAX_BATCH = 4
BURST = 8
#: concurrent requests of the overload burst (three times ``MAX_PENDING``)
OVERLOAD = 24
#: 143 phone ids: 3 segments of the 50-phone text bucket
LONG_TEXT = " ".join(TEXTS)
#: the full-context stream against ``synthesize``: fp32 codec convolutions
#: (TF32 off) at two decode buckets (448 against 1344 frames)
STREAM_TOL = 1e-4
#: the HTTP stream's L16 samples against ``synthesize_stream``'s chunks
#: quantized the same way: the same codes and decodes, so at most one
#: rounding step apart
PCM_TOL = 1
JOIN_S = 600


# ---------------- the client ----------------

def post(port: int, path: str, obj: dict) -> dict:
    """One POST on a fresh connection → status, headers, body and seconds."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=JOIN_S)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        out = {"status": r.status, "headers": dict(r.getheaders()), "body": r.read()}
    finally:
        conn.close()
    out["seconds"] = time.perf_counter() - t0
    return out


def get_json(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=JOIN_S)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        check(r.status == 200, f"GET {path}: {r.status}")
        return json.loads(r.read())
    finally:
        conn.close()


def stream(port: int, obj: dict) -> dict:
    """POST /tts_stream over a raw socket, parsing the chunked body as it
    arrives → status, headers, the chunks, each chunk's arrival second and
    the second the terminating chunk arrived (from the request's start)."""
    body = json.dumps(obj).encode()
    t0 = time.perf_counter()
    chunks, times, end = [], [], None
    with socket.create_connection(("127.0.0.1", port), timeout=JOIN_S) as sock:
        sock.sendall(f"POST /tts_stream HTTP/1.1\r\nHost: localhost\r\nContent-Type: "
                     f"application/json\r\nContent-Length: {len(body)}\r\nConnection: close"
                     "\r\n\r\n".encode() + body)
        buf, head = b"", None
        while end is None and (data := sock.recv(1 << 16)):
            buf += data
            if head is None:
                if b"\r\n\r\n" not in buf:
                    continue
                head, buf = buf.split(b"\r\n\r\n", 1)
                lines = head.decode().split("\r\n")
                headers = dict(line.split(": ", 1) for line in lines[1:])
                status = int(lines[0].split()[1])
                if headers.get("Transfer-Encoding") != "chunked":
                    break
            while b"\r\n" in buf:
                size_line, rest = buf.split(b"\r\n", 1)
                size = int(size_line, 16)
                if size == 0:
                    end = time.perf_counter() - t0
                    break
                if len(rest) < size + 2:
                    break
                chunks.append(rest[:size])
                times.append(time.perf_counter() - t0)
                buf = rest[size + 2:]
    check(head is not None, "/tts_stream: no response head")
    return {"status": status, "headers": headers, "chunks": chunks, "times": times,
            "end": end, "body": buf}


def concurrently(fn, args_list: list[tuple]) -> tuple[list, float]:
    """``fn(*args)`` on one thread each, released together → (results in
    order, wall seconds from the release to the last result); a call that
    raised fails the check with its error."""
    results = [None] * len(args_list)
    gate = threading.Barrier(len(args_list) + 1)

    def run(i, args):
        gate.wait()
        try:
            results[i] = fn(*args)
        except Exception as e:  # noqa: BLE001 — reported below
            results[i] = e

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(args_list)]
    for th in threads:
        th.start()
    gate.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=JOIN_S)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "a client thread did not finish")
    failed = [repr(r) for r in results if isinstance(r, Exception)]
    check(not failed, f"{len(failed)} of {len(results)} concurrent calls raised: {failed[:3]}")
    return results, wall


def wav_frames(body: bytes) -> tuple[int, int]:
    """A .wav body → (sample rate, samples)."""
    with wave.open(io.BytesIO(body)) as f:
        return f.getframerate(), f.getnframes()


def pcm(wav: np.ndarray) -> np.ndarray:
    """Float samples → the L16 samples the stream sends."""
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int32)


# ---------------- the server ----------------

class Served:
    """``make_server`` over ``synth`` with a ``Batcher``, serving in a thread;
    ``entered`` is set whenever a /tts request reaches the Batcher."""

    def __init__(self, synth, window_ms: float = WINDOW_MS, max_pending: int = MAX_PENDING):
        self.synth = synth
        self.batcher = serve.Batcher(synth, window_ms)
        self.entered = threading.Event()
        submit = self.batcher.submit

        def entering(*a, **kw):
            self.entered.set()
            return submit(*a, **kw)

        self.batcher.submit = entering
        self.server = serve.make_server(synth, "127.0.0.1", 0, self.batcher,
                                        max_pending=max_pending)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def drain(self):
        self.server.drain()
        self.thread.join(timeout=JOIN_S)
        check(not self.thread.is_alive(), "serve_forever did not return after drain()")


class checked_wavs:
    """Context manager: every wav ``serve.wav_bytes`` encodes is recorded
    with whether all its samples are finite."""

    def __enter__(self):
        self.seen: list[tuple[int, bool]] = []
        real = serve.wav_bytes

        def wrapped(wav, sr):
            self.seen.append((len(wav), bool(np.isfinite(wav).all())))
            return real(wav, sr)

        self._patch = mock.patch.object(serve, "wav_bytes", wrapped)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()
        return False


def latency_summary(secs: list[float], wall: float) -> dict:
    return {"p50_ms": float(np.percentile(secs, 50) * 1e3),
            "p90_ms": float(np.percentile(secs, 90) * 1e3),
            "requests_per_s": len(secs) / wall, "wall_s": wall, "n": len(secs)}


# ---------------- the phase ----------------

def _tts_burst(served: Served, requests: list[dict], frames) -> tuple[list[dict], float]:
    """Concurrent /tts requests; each must return 200 and a wav whose
    sample count ``frames(i, n)`` accepts."""
    with checked_wavs() as seen:
        res, wall = concurrently(lambda r: post(served.port, "/tts", r), [(r,) for r in requests])
    for i, r in enumerate(res):
        check(r["status"] == 200, f"/tts request {i}: {r['status']} {r['body'][:200]!r}")
        check(r["headers"].get("Content-Type") == "audio/wav", f"/tts request {i}: not a wav")
        sr, n = wav_frames(r["body"])
        check(sr == 24000 and frames(i, n), f"/tts request {i}: {n} samples at {sr} Hz")
    check(len(seen.seen) == len(res) and all(ok for _, ok in seen.seen),
          f"non-finite samples in the served wavs: {seen.seen}")
    return res, wall


def d3pm_server_checks(synth, refs, seed: int, smi: str, label: str = "serve http") -> dict:
    """The D3PM server's traffic (after its warm-up): the concurrent burst,
    the stream, the overload burst, /stats and the kernel counts, the drain."""
    on_card = synth.device.type == "cuda"
    per_batch = sum(s.count for s in attention_sites(synth.first.config, nar_dims_of(synth.nar),
                                                     synth.denoiser_calls, 256))
    served = Served(synth)
    out = {"per_batch": per_batch}
    try:
        with synth._prom_cache_lock:  # the burst's encodes run beside device batches
            synth._prom_cache.clear()
        _reset_counts()
        reqs = [{"text": TEXTS[i % len(TEXTS)], "reference": str(refs[i % 3]), "seed": seed + i}
                for i in range(BURST)]
        res, wall = _tts_burst(served, reqs, lambda i, n: n == synth.gen_len * 320)
        out["burst"] = latency_summary([r["seconds"] for r in res], wall)
        log(f"{label}: {BURST} concurrent /tts p50 {out['burst']['p50_ms']:.1f} ms, p90 "
            f"{out['burst']['p90_ms']:.1f} ms, {out['burst']['requests_per_s']:.2f} requests/s "
            f"(host clock at the client, through HTTP) on {smi}")

        st = stream(served.port, {"text": LONG_TEXT, "reference": str(refs[0]), "seed": seed})
        check(st["status"] == 200, f"/tts_stream: {st['status']} {st['body'][:200]!r}")
        check(st["headers"].get("Content-Type") == "audio/L16; rate=24000; channels=1",
              f"/tts_stream: {st['headers']}")
        check(len(st["chunks"]) >= 3 and st["end"] is not None,
              f"/tts_stream: {len(st['chunks'])} chunks, end {st['end']}")
        check(st["times"][0] < st["times"][-1] <= st["end"],
              f"/tts_stream: the first chunk did not arrive before the stream ended "
              f"({st['times']})")
        out["stream"] = {"chunks": len(st["chunks"]), "first_audio_s": st["times"][0],
                         "chunk_s": st["times"], "total_s": st["end"]}
        log(f"{label}: /tts_stream of {len(st['chunks'])} segments: first audio after "
            f"{st['times'][0] * 1e3:.1f} ms, whole stream {st['end'] * 1e3:.1f} ms (host clock "
            f"at the client) on {smi}")

        with checked_wavs() as seen:
            over, _ = concurrently(lambda r: post(served.port, "/tts", r),
                                   [({"text": TEXTS[i % len(TEXTS)], "reference": str(refs[i % 3]),
                                      "seed": seed + 100 + i},) for i in range(OVERLOAD)])
        shed = [r for r in over if r["status"] == 503]
        ok = [r for r in over if r["status"] == 200]
        check(len(shed) + len(ok) == OVERLOAD, f"overload: {[r['status'] for r in over]}")
        check(len(seen.seen) == len(ok) and all(f for _, f in seen.seen),
              f"overload: non-finite samples in the served wavs: {seen.seen}")
        check(len(shed) >= 1, f"overload: {OVERLOAD} requests over max_pending {MAX_PENDING}, "
                              "none shed")
        check(all(r["headers"].get("Retry-After") == "1" and json.loads(r["body"])["error"]
                  == "overloaded" for r in shed), "a 503 without Retry-After: 1")
        out["overload"] = {"sent": OVERLOAD, "shed": len(shed), "served": len(ok)}
        log(f"{label}: overload burst of {OVERLOAD}: {len(shed)} shed with 503, {len(ok)} served")

        stats = get_json(served.port, "/stats")
        counts = _counts()
        rows = BURST + len(st["chunks"]) + len(ok)
        check(stats["requests"] == BURST + 1 + len(ok) and stats["errors"] == 0
              and stats["streams"] == 1 and stats["rejected"] == len(shed),
              f"/stats {stats} against {BURST} + {len(ok)} /tts, 1 stream, {len(shed)} shed")
        occ = stats["mean_batch_occupancy"]
        check(-(-rows // MAX_BATCH) <= stats["batches"] <= rows
              and abs(occ * stats["batches"] - rows) <= 0.01 * stats["batches"] and occ > 1,
              f"/stats batches {stats['batches']} x occupancy {occ} against {rows} rows")
        check(stats["latency_ms"]["n"] == stats["requests"], f"/stats latencies {stats}")
        check(stats["prom_cache"]["size"] == 3, f"/stats prompt cache {stats['prom_cache']}")
        want = stats["batches"] * per_batch
        k1 = counts["kernel1"] if on_card else counts["kernel1_plain"]
        check(k1 == want, f"{label}: kernel-1 calls {counts} != {stats['batches']} batches x "
                          f"{per_batch}")
        if on_card:
            check(counts["kernel1_plain"] == 0, f"{label}: the plain path ran on the card")
        out.update(stats=stats, launches=counts, rows=rows)
        log(f"{label}: /stats {json.dumps(stats)}; kernel 1 launches {counts['kernel1']} (plain "
            f"{counts['kernel1_plain']}) = {stats['batches']} device batches x {per_batch}")

        # the prompt codes encoded beside the device batches equal a serial encode
        from .audio.wavio import read_wav

        for ref in refs[:3]:
            wav, sr = read_wav(ref)
            check(np.array_equal(synth.prompt_codes(ref), synth.codec.encode(wav, sr).T),
                  f"{ref.name}: the concurrent encode differs from a serial one")

        # the HTTP stream against synthesize_stream; the full-context stream
        # against synthesize
        want_chunks = list(synth.synthesize_stream(LONG_TEXT, refs[0], seed))
        got = [np.frombuffer(c, ">i2").astype(np.int32) for c in st["chunks"]]
        check([len(g) for g in got] == [len(w) for w in want_chunks],
              "/tts_stream chunk lengths differ from synthesize_stream's")
        pcm_err = max(int(np.abs(g - pcm(w)).max()) for g, w in zip(got, want_chunks))
        check(pcm_err <= PCM_TOL, f"/tts_stream against synthesize_stream: {pcm_err} > {PCM_TOL}")
        with full_fp32():  # TF32 convolutions would round the two decodes apart
            whole, _ = synth.synthesize(LONG_TEXT, refs[0], seed)
            full = np.concatenate(list(synth.synthesize_stream(LONG_TEXT, refs[0], seed,
                                                               context_frames=10 ** 6)))
        err = float(np.abs(full - whole).max())
        check(full.shape == whole.shape and err <= STREAM_TOL,
              f"full-context stream against synthesize: {err:.3g} > {STREAM_TOL}")
        http_err = float(np.abs(np.concatenate(got) / 32767.0 - np.clip(whole, -1, 1)).max())
        out["stream"].update(pcm_err=pcm_err, full_context_err=err, http_vs_synthesize=http_err)
        log(f"{label}: /tts_stream PCM vs synthesize_stream max |d| {pcm_err} LSB (bound "
            f"{PCM_TOL}); full-context stream vs synthesize max |d| {err:.3g} (bound "
            f"{STREAM_TOL}); the served stream (context 112 frames) vs synthesize {http_err:.3g}")

        # drain with a long-form request in flight
        served.entered.clear()
        box = {}
        inflight = threading.Thread(target=lambda: box.setdefault("r", post(
            served.port, "/tts", {"text": LONG_TEXT, "reference": str(refs[1]), "seed": seed})))
        inflight.start()
        check(served.entered.wait(timeout=JOIN_S), "the drain's request never reached the Batcher")
        t0 = time.perf_counter()
        served.drain()
        inflight.join(timeout=JOIN_S)
        r = box.get("r")
        check(r is not None and r["status"] == 200
              and wav_frames(r["body"])[1] == 3 * synth.gen_len * 320,
              f"the request in flight at drain(): {r and (r['status'], r['body'][:200])}")
        out["drain_s"] = time.perf_counter() - t0
        log(f"{label}: drain() with a long-form request in flight: it completed (200, 3 segments) "
            f"and the server stopped in {out['drain_s']:.2f} s")
    finally:
        served.server.shutdown()
        served.server.server_close()
    return out


def cohort_check(synth, refs, seed: int, label: str, assert_equal: bool) -> dict:
    """4 requests, each alone through the ``Batcher`` and then all 4 inside
    one cohort → the share of identical codes and the first divergence."""
    batcher = serve.Batcher(synth, window_ms=300.0)
    batcher.stats = serve.ServerStats()
    rows = [synth.prepare(TEXTS[i], refs[i % 3]) for i in range(4)]
    seeds = [seed + 7 * i for i in range(4)]
    alone = [batcher.submit_row(r, s) for r, s in zip(rows, seeds)]
    cohort, _ = concurrently(batcher.submit_row, list(zip(rows, seeds)))
    snap = batcher.stats.snapshot()
    check(snap["batches"] == 5 and snap["mean_batch_occupancy"] == 1.6,
          f"{label}: batches {snap} (4 alone, then one of 4)")
    same = sum(int((a == c).sum()) for a, c in zip(alone, cohort))
    total = sum(a.size for a in alone)
    level0 = sum(int((a[:, 0] == c[:, 0]).sum()) for a, c in zip(alone, cohort))
    div = None
    for i, (a, c) in enumerate(zip(alone, cohort)):
        diff = np.argwhere(a != c)
        if len(diff):
            div = (i, *map(int, diff[0]))
            break
    out = {"identical": div is None, "share": same / total,
           "level0_share": level0 / sum(len(a) for a in alone), "first_divergence": div}
    log(f"{label}: codes alone vs in a cohort of 4 identical {out['identical']}, share "
        f"{out['share']:.4f} (level 0 {out['level0_share']:.4f}), first divergence "
        f"(request, frame, level) {div}")
    if assert_equal:
        check(div is None, f"{label}: a request's codes depend on its cohort: first divergence "
                           f"(request, frame, level) {div}")
    return out


def phase_serve_http(device, d3pm_bundle, nar_bundle, ar_bundle, seed: int = 0, codec=None,
                     ref_seconds: float = 3.0, max_ar_steps: int = 448, smi: str = "n/a") -> dict:
    """The phase (see the module docstring) over exported bundles; ``codec``
    replaces ``from_bundles``'s (the CPU rehearsal's small one)."""
    from .serve import Synthesizer

    device = torch.device(device)
    refs = reference_wavs(4, ref_seconds, seed + 100)  # 3 for the traffic, 1 for the warm-up

    def load(first, bf16=True, **kw):
        s = Synthesizer.from_bundles(first, nar_bundle, None, device=device, max_batch=MAX_BATCH,
                                     bf16=bf16, **kw)
        if codec is not None:
            s.codec = codec
        return s

    out = {}
    synth = load(d3pm_bundle)
    timed = []
    for step, ref in (("without warmup", refs[0]), ("warmup", refs[3]),
                      ("after warmup", refs[1])):
        _sync(device)
        t0 = time.perf_counter()
        if step == "warmup":
            synth.warmup(ref)
        else:
            synth.synthesize(TEXTS[0], ref, seed)
        _sync(device)
        timed.append(time.perf_counter() - t0)
    out["first_request_s"] = {"without_warmup": timed[0], "warmup": timed[1],
                              "after_warmup": timed[2]}
    log(f"serve http: the first request of a fresh Synthesizer {timed[0] * 1e3:.1f} ms without "
        f"warmup; warmup {timed[1] * 1e3:.1f} ms; the first request after it "
        f"{timed[2] * 1e3:.1f} ms (B=1, an uncached reference each; host clock) on {smi}")
    out["d3pm"] = d3pm_server_checks(synth, refs, seed, smi)
    out["cohort bf16"] = cohort_check(synth, refs, seed, "serve http cohort, bf16 (printed)",
                                      assert_equal=False)
    del synth
    if device.type == "cuda":
        torch.cuda.empty_cache()

    with full_fp32():
        synth32 = load(d3pm_bundle, bf16=False)
        out["cohort fp32"] = cohort_check(synth32, refs, seed, "serve http cohort, fp32",
                                          assert_equal=False)
    del synth32
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ar = load(ar_bundle, max_ar_steps=max_ar_steps, temperature=1.0)
    for ref in refs[:3]:  # cached: the burst's requests reach the Batcher together
        ar.prompt_codes(ref)
    served = Served(ar)
    try:
        _reset_counts()
        reqs = [{"text": TEXTS[i % len(TEXTS)], "reference": str(refs[i % 3]), "seed": seed + i}
                for i in range(BURST)]
        res, wall = _tts_burst(served, reqs,
                               lambda i, n: n % 320 == 0 and 1 <= n // 320 <= max_ar_steps)
        stats = get_json(served.port, "/stats")
        counts = _counts()
        per = {"kernel2": ar.first.base.n_layers, "kernel1": 7 * ar.nar.base.n_layers}
        got = ({k: counts[k] for k in per} if device.type == "cuda"
               else {k: counts[f"{k}_plain"] for k in per})
        check(got == {k: v * stats["batches"] for k, v in per.items()},
              f"serve http ar: launches {counts} != {stats['batches']} batches x {per}")
        if device.type == "cuda":
            check(counts["kernel1_plain"] == counts["kernel2_plain"] == counts["kernel2_bwd"] == 0,
                  f"serve http ar: a plain version or a backward ran on the card: {counts}")
        check(stats["requests"] == BURST and stats["errors"] == 0
              and abs(stats["mean_batch_occupancy"] * stats["batches"] - BURST) <= 0.01 * BURST,
              f"serve http ar: /stats {stats}")
        out["ar"] = {"burst": latency_summary([r["seconds"] for r in res], wall),
                     "stats": stats, "launches": counts, "per_batch": per}
        log(f"serve http ar: {BURST} concurrent /tts p50 {out['ar']['burst']['p50_ms']:.1f} ms, "
            f"p90 {out['ar']['burst']['p90_ms']:.1f} ms, "
            f"{out['ar']['burst']['requests_per_s']:.3f} requests/s in {stats['batches']} batches "
            f"(occupancy {stats['mean_batch_occupancy']}); kernel 2 forwards {counts['kernel2']}, "
            f"kernel 1 launches {counts['kernel1']} (plain {counts['kernel2_plain']}, "
            f"{counts['kernel1_plain']}) on {smi}")
    finally:
        served.drain()

    fp32 = out["cohort fp32"]
    check(fp32["identical"], "serve http cohort, fp32: a request's codes depend on its cohort: "
                             f"first divergence (request, frame, level) {fp32['first_divergence']}")
    return out


def write_seeded_bundles(root, size: str = "full", seed: int = 0):
    """D3PM, NAR and AR bundles at ``size`` ("full": the registry defaults,
    "tiny": ``smoke.tiny_models``' widths) from weights drawn from ``seed``,
    written in f16 under ``root`` → (diffusion, nar, ar) paths."""
    from .convert import init_seeded
    from .export import bundle_params, save_bundle
    from .models import get_model
    from .smoke import default_symmap, full_models, tiny_models

    first, nar, dims, _ = (full_models if size == "full" else tiny_models)(torch.float32)
    ar = get_model("ar", 1024, dims, dtype=torch.float32)
    for i, m in enumerate((first.denoiser, nar, ar)):
        init_seeded(m, seed + i)
    c = first.config
    metas = {"diffusion": dict(model="diffusion", timesteps=c.timesteps, resp_len=c.resp_len,
                               text_len=c.text_len, prom_len=c.prom_len, gen_len=c.gen_len,
                               d_model=c.d_model, n_heads=c.n_heads, n_layers=c.n_layers),
             "nar": dict(model="nar", **dims), "ar": dict(model="ar", **dims)}
    paths = []
    for name, module in (("diffusion", first), ("nar", nar), ("ar", ar)):
        flat = {k: v.astype(np.float16) for k, v in bundle_params(module).items()}
        save_bundle(root / name, flat, dict(metas[name], num_tokens=1024), default_symmap(),
                    {"spk": 0})
        paths.append(root / name)
    return tuple(paths)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="the serve http phase alone, on the card, "
                                                 "over seeded full-width bundles")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    info = phase_device(device)  # raises without a card
    with phase("build"):
        phase_build(device)
    bundles = write_seeded_bundles(SMOKE_DIR / "serve_seeded", "full", args.seed)
    log(f"seeded full-width bundles in {time.perf_counter() - t0:.1f} s")
    with phase("serve http"):
        phase_serve_http(device, *bundles, seed=args.seed, smi=info["smi"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
