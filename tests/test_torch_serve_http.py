"""The port's serving runtime on the CPU: ``ServerStats`` and ``wav_bytes``
against the JAX package's, ``Batcher`` cohorts, the HTTP server
(``make_server``: /healthz, /stats, /tts, /tts_stream, 404, 500, 503 under
``max_pending``, the drain) and the serving CLI (its refusals, and the
server it starts answering until SIGTERM), on a tiny seeded D3PM, NAR and
codec in fp32."""

import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tts_with_diffusion_model_tpu.serve as jax_serve
from tts_with_diffusion_model_tpu_torch import longform, serve, smoke
from tts_with_diffusion_model_tpu_torch.serve import Batcher, ServerStats, make_server, wav_bytes
from tts_with_diffusion_model_tpu_torch.smoke_serve import concurrently, post, stream

from torch_port_helpers import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = Path(__file__).resolve().parents[1]
LONG_TEXT = " ".join(smoke.TEXTS)  # 143 phone ids: 3 segments of the 50-phone bucket
JOIN_S = 120


@pytest.fixture(scope="module")
def served():
    """A tiny D3PM synthesizer (text bucket 50, 40 frames) batching up to 4
    requests, and two reference wavs."""
    synth, _ = smoke.build_synthesizer("cpu", "tiny", zoo=False, seed=0, max_batch=4)
    return synth, smoke.reference_wavs(2, 0.4, seed=51)


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server.server_address[1], thread


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=JOIN_S)
    conn.request("GET", path)
    r = conn.getresponse()
    out = r.status, r.read()
    conn.close()
    return out


def _post(port, path, obj):
    r = post(port, path, obj)
    return r["status"], r["headers"], r["body"]


# ---------------- pure Python parts, against the JAX package ----------------

@pytest.mark.parametrize("n_lat", [0, 3, 700])
def test_server_stats_snapshot_matches_jax(monkeypatch, n_lat):
    """The same records → the same snapshot keys and values (the latency
    window keeps the last 512 samples)."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    ours, ref = ServerStats(), jax_serve.ServerStats()
    rs = np.random.RandomState(n_lat)
    for i in range(n_lat):
        kw = dict(error=bool(rs.rand() < 0.2), stream=bool(rs.rand() < 0.3))
        secs = float(rs.gamma(2.0, 0.05))
        for s in (ours, ref):
            s.record(secs, **kw)
        if i % 3 == 0:
            rows = int(rs.randint(1, 5))
            for s in (ours, ref):
                s.record_batch(rows)
        if i % 7 == 0:
            for s in (ours, ref):
                s.record_rejected()
    assert ours.snapshot() == ref.snapshot()


@pytest.mark.parametrize("sr,n", [(24000, 4000), (16000, 1), (24000, 0)])
def test_wav_bytes_matches_jax(sr, n):
    wav = (np.random.RandomState(n).randn(n) * 0.7).astype(np.float32)  # some beyond ±1
    assert wav_bytes(wav, sr) == jax_serve.wav_bytes(wav, sr)


# ---------------- Batcher ----------------

def test_batcher_cohort_of_four_gives_each_request_its_solo_codes(served):
    """4 threads inside one window: one device batch of 4 (stats: one batch,
    occupancy 4), each request's codes equal to its own batch of one, and
    the wavs within the codec's batch rounding (1e-5)."""
    synth, refs = served
    batcher = Batcher(synth, window_ms=2000.0)
    batcher.stats = ServerStats()
    rows = [synth.prepare(smoke.TEXTS[i], refs[i % 2]) for i in range(4)]
    got, _ = concurrently(batcher.submit_row, [(rows[i], 10 + i) for i in range(4)])
    snap = batcher.stats.snapshot()
    assert snap["batches"] == 1 and snap["mean_batch_occupancy"] == 4
    for i in range(4):
        np.testing.assert_array_equal(got[i], synth.synthesize_codes_batch([rows[i]], [10 + i])[0])
    wavs, _ = concurrently(batcher.submit, [(smoke.TEXTS[i], refs[i % 2], 20 + i)
                                            for i in range(4)])
    assert batcher.stats.snapshot()["batches"] == 2
    for i in range(4):
        wav, sr = wavs[i]
        solo, _ = synth.synthesize(smoke.TEXTS[i], refs[i % 2], seed=20 + i)
        assert sr == 24000 and wav.shape == solo.shape == (synth.gen_len * 320,)
        np.testing.assert_allclose(wav, solo, atol=1e-5)


def test_batcher_errors_reach_every_caller_in_the_cohort(served, monkeypatch):
    synth, refs = served
    batcher = Batcher(synth, window_ms=2000.0)
    batcher.stats = ServerStats()
    row = synth.prepare(smoke.TEXTS[0], refs[0])

    def boom(prepared, seeds, want_wav=False):
        raise RuntimeError(f"device batch of {len(prepared)} failed")

    monkeypatch.setattr(synth, "_device_batch", boom)

    def call(seed):
        try:
            batcher.submit_row(row, seed)
        except RuntimeError as e:
            return str(e)

    errors, _ = concurrently(call, [(s,) for s in range(3)])
    assert errors == ["device batch of 3 failed"] * 3
    assert batcher.stats.snapshot()["batches"] == 1


def test_batcher_long_request_rides_the_queue(served, monkeypatch):
    """Each segment of a long-form request goes through ``submit_row``; the
    wav equals ``synthesize_long`` run directly."""
    synth, refs = served
    batcher = Batcher(synth, window_ms=1.0)
    seeds = []
    real = batcher.submit_row

    def spy(row, seed=0):
        seeds.append(seed)
        return real(row, seed)

    monkeypatch.setattr(batcher, "submit_row", spy)
    wav, sr = batcher.submit(LONG_TEXT, refs[0], 5)
    assert seeds == [longform.segment_seed(5, i) for i in range(3)]
    ref, _ = longform.synthesize_long(synth, LONG_TEXT, refs[0], seed=5)
    assert sr == 24000 and wav.shape == ref.shape == (3 * synth.gen_len * 320,)
    np.testing.assert_array_equal(wav, ref)


def test_batcher_mixed_wav_and_codes_traffic(served):
    """A cohort of a direct request (wav) and a segment row (codes): each
    caller gets its kind of result, equal to its solo run."""
    synth, refs = served
    batcher = Batcher(synth, window_ms=2000.0)
    batcher.stats = ServerStats()
    row = synth.prepare(smoke.TEXTS[1], refs[1])
    ((wav, _), codes), _ = concurrently(
        lambda kind: (batcher.submit(smoke.TEXTS[0], refs[0], 11) if kind == "wav"
                      else batcher.submit_row(row, 22)), [("wav",), ("codes",)])
    assert batcher.stats.snapshot()["mean_batch_occupancy"] == 2
    np.testing.assert_array_equal(codes, synth.synthesize_codes_batch([row], [22])[0])
    solo, _ = synth.synthesize(smoke.TEXTS[0], refs[0], seed=11)
    np.testing.assert_allclose(wav, solo, atol=1e-5)


# ---------------- the HTTP server ----------------

@pytest.mark.parametrize("batched", [False, True])
def test_http_endpoints(served, batched):
    synth, refs = served
    batcher = Batcher(synth, window_ms=1.0) if batched else None
    server = make_server(synth, "127.0.0.1", 0, batcher)
    port, loop = _start(server)
    try:
        status, body = _get(port, "/healthz")
        assert status == 200 and json.loads(body) == {"status": "ok"}

        req = {"text": smoke.TEXTS[2], "reference": str(refs[0]), "seed": 3}
        status, headers, body = _post(port, "/tts", req)
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        assert body == wav_bytes(*synth.synthesize(smoke.TEXTS[2], refs[0], seed=3))
        with wave.open(io.BytesIO(body)) as f:
            assert f.getframerate() == 24000 and f.getnframes() == synth.gen_len * 320

        st = stream(port, {"text": LONG_TEXT, "reference": str(refs[1]), "seed": 4})
        chunks, headers = st["chunks"], st["headers"]
        assert st["status"] == 200 and st["end"] is not None
        assert headers["Content-Type"] == "audio/L16; rate=24000; channels=1"
        assert headers["Transfer-Encoding"] == "chunked"
        want = list(synth.synthesize_stream(LONG_TEXT, refs[1], seed=4))
        assert len(chunks) == len(want) == 3
        for c, w in zip(chunks, want):
            assert c == (np.clip(w, -1, 1) * 32767.0).astype(">i2").tobytes()

        for path in ("/tts", "/tts_stream"):
            status, headers, body = _post(port, path, {"text": "hi", "reference": "/no/such.wav"})
            assert status == 500 and headers["Content-Type"] == "application/json"
            assert "such.wav" in json.loads(body)["error"]
        assert _get(port, "/nowhere")[0] == 404
        assert _post(port, "/nowhere", {})[0] == 404

        status, body = _get(port, "/stats")
        snap = json.loads(body)
        assert status == 200
        assert (snap["requests"], snap["errors"], snap["streams"], snap["rejected"]) == (4, 2, 2, 0)
        assert snap["latency_ms"]["n"] == 4 and snap["latency_ms"]["p50"] > 0
        assert snap["prom_cache"]["size"] == 2 and snap["prom_cache"]["misses"] <= 2
        if batched:  # the /tts request and the stream's three segments
            assert snap["batches"] == 4 and snap["mean_batch_occupancy"] == 1
        else:
            assert snap["batches"] == 0 and snap["mean_batch_occupancy"] is None
    finally:
        server.drain()
    loop.join(timeout=JOIN_S)
    assert not loop.is_alive()


def _slow(monkeypatch, synth, started: threading.Event, release: threading.Event):
    orig = synth.synthesize

    def slow(*a, **kw):
        started.set()
        release.wait(timeout=JOIN_S)
        return orig(*a, **kw)

    monkeypatch.setattr(synth, "synthesize", slow)


def test_overload_sheds_with_503(served, monkeypatch):
    """``max_pending`` 1: a second request while the first is in flight gets
    503 with ``Retry-After: 1``; the slot frees afterwards; /stats counts the
    rejection apart from errors and latencies."""
    synth, refs = served
    started, release = threading.Event(), threading.Event()
    _slow(monkeypatch, synth, started, release)
    server = make_server(synth, "127.0.0.1", 0, max_pending=1)
    port, _ = _start(server)
    req = {"text": smoke.TEXTS[0], "reference": str(refs[0])}
    res = {}
    first = threading.Thread(target=lambda: res.__setitem__("a", _post(port, "/tts", req)))
    first.start()
    try:
        assert started.wait(timeout=JOIN_S)
        for path in ("/tts", "/tts_stream"):
            status, headers, body = _post(port, path, req)
            assert status == 503 and headers["Retry-After"] == "1"
            assert json.loads(body) == {"error": "overloaded", "retry_after_s": 1}
        release.set()
        first.join(timeout=JOIN_S)
        assert res["a"][0] == 200
        assert _post(port, "/tts", req)[0] == 200
        snap = json.loads(_get(port, "/stats")[1])
        assert (snap["rejected"], snap["errors"], snap["requests"]) == (2, 0, 2)
        assert snap["latency_ms"]["n"] == 2
    finally:
        release.set()
        server.drain()


def test_drain_finishes_the_request_in_flight(served, monkeypatch):
    """``drain()`` (what SIGTERM sequences) stops accepting but completes the
    request in flight; ``serve_forever`` returns and the port is released."""
    synth, refs = served
    started, release = threading.Event(), threading.Event()
    _slow(monkeypatch, synth, started, release)
    server = make_server(synth, "127.0.0.1", 0)
    port, loop = _start(server)
    res = {}
    call = threading.Thread(target=lambda: res.__setitem__("r", _post(
        port, "/tts", {"text": smoke.TEXTS[1], "reference": str(refs[1])})))
    call.start()
    assert started.wait(timeout=JOIN_S)
    threading.Timer(0.5, release.set).start()
    server.drain()
    call.join(timeout=JOIN_S)
    loop.join(timeout=JOIN_S)
    assert not call.is_alive() and not loop.is_alive()
    status, _, body = res["r"]
    assert status == 200
    with wave.open(io.BytesIO(body)) as f:
        assert f.getnframes() == synth.gen_len * 320
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=5)


# ---------------- the serving CLI ----------------

@pytest.fixture(scope="module")
def tiny_bundles(tmp_path_factory):
    """A tiny diffusion bundle (T = 20, gen_len 40), a tiny NAR bundle and a
    tiny Gaussian bundle (T = 4), written by the JAX package's exporter."""
    from tts_with_diffusion_model_tpu.export import save_bundle
    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig, DiffusionModel
    from tts_with_diffusion_model_tpu.models.nar import NAR

    root = tmp_path_factory.mktemp("serve_bundles")
    dims = dict(d_model=32, n_heads=2, n_layers=2)
    meta = dict(model="diffusion", num_tokens=1024, timesteps=20, resp_len=64, text_len=50,
                prom_len=64, gen_len=40, **dims)
    jm = DiffusionModel(DiffusionConfig(n_classes=1025, **{k: v for k, v in meta.items()
                                                          if k not in ("model", "num_tokens")}))
    symmap = smoke.default_symmap()
    save_bundle(root / "diffusion", jax.jit(jm.init)(jax.random.PRNGKey(0)), meta, symmap,
                {"spk": 0})
    z = np.zeros((1, 4), np.int32)
    f = z.astype(np.float32)
    resp = np.zeros((1, 4, 8), np.int32)
    nar = jax.jit(NAR(1024, remat=False, **dims).init)(jax.random.PRNGKey(1), z, f, resp, f, resp,
                                                        f, jnp.zeros((1,), jnp.int32))
    save_bundle(root / "nar", nar, dict(model="nar", num_tokens=1024, **dims), symmap, {"spk": 0})
    from tts_with_diffusion_model_tpu.models.gaussian_tts import (GaussianConfig,
                                                                   GaussianDiffusionModel)

    gmeta = dict(model="diffusion-gaussian", num_tokens=1024, timesteps=4, resp_len=48,
                 text_len=50, prom_len=64, gen_len=40, **dims)
    gm = GaussianDiffusionModel(GaussianConfig(**{k: v for k, v in gmeta.items()
                                                  if k not in ("model", "num_tokens")}))
    save_bundle(root / "gaussian", jax.jit(gm.init)(jax.random.PRNGKey(2)), gmeta, symmap,
                {"spk": 0})
    return root


@pytest.mark.parametrize("case,match", [("mesh_tp", "item 14"), ("gaussian", "D3PM samplers")])
def test_serve_cli_refusals(tiny_bundles, capsys, case, match):
    """``--mesh-tp 2`` is not ported; a Gaussian bundle is served, but the
    D3PM's ``--stride`` is refused for it."""
    argv = ["--device", "cpu", "--nar-ckpt", str(tiny_bundles / "nar"), "--ar-ckpt",
            str(tiny_bundles / ("gaussian" if case == "gaussian" else "diffusion"))]
    argv += ["--mesh-tp", "2"] if case == "mesh_tp" else ["--stride", "3"]
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    assert e.value.code == 2 and match in capsys.readouterr().err


def test_serve_cli_refuses_cuda_without_a_card(tiny_bundles):
    """The serving CLI defaults to the card and does not fall back to the
    CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--ar-ckpt", str(tiny_bundles / "diffusion"),
                    "--nar-ckpt", str(tiny_bundles / "nar")])


def test_serve_cli_answers_until_sigterm(tiny_bundles):
    """``python -m tts_with_diffusion_model_tpu_torch.serve --device cpu``
    on any free port: /healthz and one /tts through its Batcher, then
    SIGTERM drains and the process exits 0."""
    ref = smoke.reference_wavs(1, 0.3, seed=52)[0]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tts_with_diffusion_model_tpu_torch.serve", "--device", "cpu",
         "--ar-ckpt", str(tiny_bundles / "diffusion"), "--nar-ckpt", str(tiny_bundles / "nar"),
         "--port", "0", "--max-batch", "2", "--maskgit-steps", "2"],
        cwd=tiny_bundles, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        log = []
        for line in proc.stderr:
            log.append(line)
            if "Serving on http://" in line:
                port = int(line.split("http://", 1)[1].split(" ")[0].rsplit(":", 1)[1])
                break
        assert port, "".join(log)
        assert json.loads(_get(port, "/healthz")[1]) == {"status": "ok"}
        status, headers, body = _post(port, "/tts", {"text": "she said hello",
                                                     "reference": str(ref), "seed": 1})
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        with wave.open(io.BytesIO(body)) as f:
            assert f.getnframes() == 40 * 320
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=JOIN_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=JOIN_S)
        proc.stderr.close()
