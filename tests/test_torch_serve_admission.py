"""The HTTP server's admission slot (``make_server``'s ``max_pending``) on
the CPU, over a stub synthesizer: a request gives its slot back before the
last bytes of its answer go out, so strictly sequential clients are never
shed, and every admitted request releases its slot exactly once, on the
200, 500 and stream paths alike."""

import threading

import numpy as np
import pytest

from tts_with_diffusion_model_tpu_torch.serve import make_server
from tts_with_diffusion_model_tpu_torch.smoke_serve import post, stream

SR = 24000


class StubSynth:
    """Answers at once: a short wav per text, three chunks per stream; a text
    of "fail" raises (the 500 paths)."""

    sample_rate = SR
    _prom_cache_lock = threading.Lock()
    _prom_cache: dict = {}
    prom_cache_hits = prom_cache_misses = 0

    def synthesize(self, text, reference, seed=0):
        if text == "fail":
            raise RuntimeError("stub failure")
        return np.full(320, 0.1, np.float32), SR

    def synthesize_stream(self, text, reference, seed=0, submit_row=None):
        if text == "fail":
            raise RuntimeError("stub failure")
        for i in range(3):
            yield np.full(320, 0.1 * i, np.float32)


class CountingSemaphore(threading.Semaphore):
    def __init__(self, value):
        super().__init__(value)
        self.acquired = self.released = 0
        self._count_lock = threading.Lock()

    def acquire(self, *a, **kw):
        ok = super().acquire(*a, **kw)
        if ok:
            with self._count_lock:
                self.acquired += 1
        return ok

    def release(self, n=1):
        with self._count_lock:
            self.released += n
        super().release(n)


def _serve(max_pending):
    server = make_server(StubSynth(), "127.0.0.1", 0, max_pending=max_pending)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def test_sequential_requests_are_never_shed():
    """300 strictly sequential /tts posts on fresh connections at
    ``max_pending`` 1: each one's slot is free before its answer is read,
    so none is shed with 503."""
    server, port = _serve(1)
    try:
        statuses = [post(port, "/tts", {"text": "hi", "reference": "r"})["status"]
                    for _ in range(300)]
    finally:
        server.drain()
    assert statuses.count(503) == 0
    assert statuses == [200] * 300


@pytest.mark.parametrize("max_pending", [1, 2])
def test_slot_released_once_per_request(max_pending):
    """A mixed run (200, 500, stream, a stream that fails before its first
    chunk, and 503s while a request holds every slot): releases equal
    admissions, and the semaphore is back at ``max_pending``."""
    server, port = _serve(max_pending)
    admit = server.admit = CountingSemaphore(max_pending)
    req, bad = {"text": "hi", "reference": "r"}, {"text": "fail", "reference": "r"}
    try:
        for _ in range(3):
            assert post(port, "/tts", req)["status"] == 200
            assert post(port, "/tts", bad)["status"] == 500
            s = stream(port, req)
            assert s["status"] == 200 and len(s["chunks"]) == 3
            assert post(port, "/tts_stream", bad)["status"] == 500
        # hold every slot: the next request is shed and releases nothing
        for _ in range(max_pending):
            assert admit.acquire(blocking=False)
        admit.acquired -= max_pending
        assert post(port, "/tts", req)["status"] == 503
        assert post(port, "/tts_stream", req)["status"] == 503
        for _ in range(max_pending):
            threading.Semaphore.release(admit)
        assert post(port, "/tts", req)["status"] == 200
    finally:
        server.drain()
    assert admit.acquired == admit.released == 13
    assert admit._value == max_pending
