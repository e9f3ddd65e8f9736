"""The port's profiler hooks (``utils/profiling.py``) on the CPU: ``trace``
writes one Chrome trace holding its ``annotate`` regions, and
``StepProfiler`` opens and closes its windows on the steps JAX's does
(JAX's profiler calls recorded instead of run)."""

import json

import pytest
import torch

from tts_with_diffusion_model_tpu.utils import profiling as jax_profiling
from tts_with_diffusion_model_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    with profiling.trace(tmp_path / "t"):
        with profiling.annotate("smoke_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "smoke_region" for e in events)


@pytest.mark.parametrize("every,n_steps,last", [(2, 3, 7), (3, 1, 9), (2, 4, 4), (0, 3, 5)])
def test_step_profiler_windows_equal_jax(tmp_path, monkeypatch, every, n_steps, last):
    """The loop calls ``maybe_start(step)`` before each step and
    ``maybe_stop(step)`` after it, then ``close()``: the same windows as
    JAX's, each written under ``profile/step_<first step>``."""
    calls = []
    monkeypatch.setattr(jax_profiling.jax.profiler, "start_trace",
                        lambda d: calls.append(("start", d.rsplit("/", 1)[-1])))
    monkeypatch.setattr(jax_profiling.jax.profiler, "stop_trace", lambda: calls.append(("stop",)))
    ref = jax_profiling.StepProfiler(tmp_path / "jax", every=every, n_steps=n_steps)
    ours = profiling.StepProfiler(tmp_path / "port", every=every, n_steps=n_steps)
    for step in range(1, last + 1):
        for prof in (ref, ours):
            prof.maybe_start(step)
        torch.ones(8) * step
        for prof in (ref, ours):
            prof.maybe_stop(step)
    ref.close()
    ours.close()
    ours.close()  # nothing left open
    want = [c[1] for c in calls if c[0] == "start"]
    assert calls.count(("stop",)) == len(want)
    got = sorted(d.name for d in (tmp_path / "port" / "profile").glob("step_*")) \
        if (tmp_path / "port" / "profile").exists() else []
    assert got == sorted(want)
    for d in got:
        assert json.loads((tmp_path / "port" / "profile" / d / "trace.json").read_text())
