"""The port's dp×tp mesh against its 1×1 runs and against the JAX package's
2×2 mesh, on the CPU: real processes in a ``gloo`` group of 4 on
127.0.0.1 (the port runs one process per device, where JAX's one process
drives the 8 virtual devices ``tests/conftest.py`` gives).

The ranks are launched once for the module (``world4``) with torchrun's
environment and run every scenario of ``run_world4``; the tests then read
what they wrote.  ``tests/test_torch_distributed.py`` launches a world of 2
the same way (``run_world2``).  The children import no JAX: this file keeps
its JAX imports inside the tests.

Tolerances (fp32): the port's mesh runs against its 1×1 runs after 3 steps
within 1e-5·max(1, |ref|) per parameter, parameters bit-identical across a
dp group after every step; the 2×2 train step against JAX's 2×2 ``Engine``
on the same weights and injected noise, the loss within 1e-5 relative and
the parameters after 2 steps within 1e-5·max(1, |ref|); a 2×2 engine's
bundle byte for byte the bundle of a 1×1 engine holding the same weights,
and JAX's logits from it within 1e-4·max(1, |ref|); sharded generation's
codes identical to one process's.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from tts_with_diffusion_model_tpu_torch.convert import init_seeded  # noqa: E402
from tts_with_diffusion_model_tpu_torch.models.ar import AR, ar_generate  # noqa: E402
from tts_with_diffusion_model_tpu_torch.models.diffusion import (  # noqa: E402
    DiffusionConfig, DiffusionModel)
from tts_with_diffusion_model_tpu_torch.models.nar import NAR  # noqa: E402
from tts_with_diffusion_model_tpu_torch.parallel.infer import (  # noqa: E402
    make_sharded_generate, shard_params)
from tts_with_diffusion_model_tpu_torch.parallel.mesh import build_mesh, shard_batch  # noqa: E402
from tts_with_diffusion_model_tpu_torch.train.engine import Engine  # noqa: E402
from tts_with_diffusion_model_tpu_torch.train.train import make_loss_fn  # noqa: E402

TINY = dict(d_model=32, n_heads=4, n_layers=2)
#: the NAR's and AR's codebook: tp divides it (the AR's 65-way head, with
#: its stop token, is ragged and replicates, as the D3PM's 65-way tables)
V = 64
DIT = dict(n_classes=65, timesteps=6, resp_len=12, text_len=7, prom_len=9, gen_len=10)
B = 4
STEPS = 3
FAMILIES = ("d3pm", "nar", "ar")
PARAM_TOL = 1e-5  # × max(1, |ref|)
CHILD_TIMEOUT_S = 240


# ---------------- the scenarios (the pytest process and the ranks) ----------------

def opt_cfg(accum: int = 1) -> dict:
    return {"scheduler": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3, "warmup_num_steps": 2,
                          "total_num_steps": 10},
            "gradient_clipping": 1.0, "gradient_accumulation_steps": accum}


def build(family: str, seed: int = 1, dropout: float = 0.1):
    """A tiny fp32 model with seeded weights (the same on every rank)."""
    if family == "d3pm":
        model = DiffusionModel(DiffusionConfig(**DIT, **TINY), dtype=torch.float32)
    elif family == "nar":
        model = NAR(V, p_dropout=dropout, remat=True, dtype=torch.float32, **TINY)
    else:
        model = AR(V, p_dropout=dropout, remat=False, dtype=torch.float32, **TINY)
    init_seeded(getattr(model, "denoiser", model), seed)
    return model


def global_batch(step: int) -> dict:
    """A global batch of 4 rows whose valid tokens differ row to row (the
    first two rows short, the last two long: unequal counts per dp rank)."""
    rs = np.random.RandomState(100 + step)
    tt, tp, tr = DIT["text_len"], DIT["prom_len"], DIT["resp_len"]
    out = dict(text=rs.randint(1, V, (B, tt)), proms=rs.randint(0, V, (B, tp, 8)),
               resps=rs.randint(0, V, (B, tr, 8)))
    for key, T, lens in (("text_mask", tt, (3, 7, 5, 7)), ("prom_mask", tp, (9, 4, 9, 6)),
                         ("resp_mask", tr, (3, 4, 12, 10))):
        out[key] = (np.arange(T)[None] < np.array(lens)[:, None]).astype(np.float32)
    out["text"] = (out["text"] * out["text_mask"]).astype(np.int64)
    out["resps"] = (out["resps"] * out["resp_mask"][..., None]).astype(np.int64)
    out["proms"] = out["proms"].astype(np.int64)
    out["resp"] = out["resps"][..., 0].copy()
    return out


def loss_fn(family: str):
    model = {"d3pm": "diffusion", "nar": "nar", "ar": "ar"}[family]
    return make_loss_fn(SimpleNamespace(model=model, max_train_diffusion_steps=None), None)


def digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_run(family: str, mesh, ckpt_root, steps: int = STEPS, zero1: bool = False,
              engine=None, accum: int = 1):
    """``steps`` engine steps on the global batches (this rank's dp rows),
    the step generator seeded alike everywhere, ``accum`` micro-batches
    per update → (engine, losses, this rank's parameter digest after each
    step)."""
    if engine is None:
        engine = Engine("model", build(family), loss_fn(family), opt_cfg(accum), ckpt_root,
                        ema_decay=0.9, mesh=mesh, zero1=zero1)
    gen = torch.Generator().manual_seed(0)
    losses, digests = [], []
    for s in range(engine.step, engine.step + steps):
        stats = engine.train_batch(shard_batch(global_batch(s), mesh), gen)
        losses.append(stats["model.loss"])
        digests.append(digest(engine.params))
    return engine, losses, digests


def gen_inputs(n: int = B):
    rs = np.random.RandomState(7)
    text = torch.as_tensor(rs.randint(1, V, (n, DIT["text_len"])))
    tm = torch.ones(n, DIT["text_len"])
    tm[1, 4:] = 0
    proms = torch.as_tensor(rs.randint(0, V, (n, DIT["prom_len"], 8)))
    pm = torch.ones(n, DIT["prom_len"])
    pm[2, 5:] = 0
    return text, tm, proms, pm


SEEDS = [11, 12, 13, 14]
SAMPLERS = {
    "maskgit": ("d3pm", lambda m, *a, **k: m.generate_maskgit(*a, steps=4, **k)),
    "ancestral s3": ("d3pm", lambda m, *a, **k: m.generate(*a, stride=3, **k)),
    "ar greedy": ("ar", lambda m, *a, **k: ar_generate(m, *a, max_steps=8,
                                                       sampling_temperature=0.0)[0]),
}


def sample_all(mesh, n: int = B) -> dict[str, np.ndarray]:
    """Every sampler's codes on the mesh (``make_sharded_generate``)."""
    out = {}
    models = {f: shard_params(mesh, build(f, seed=3, dropout=0.0).eval()) for f in ("d3pm", "ar")}
    for name, (family, fn) in SAMPLERS.items():
        gen = make_sharded_generate(models[family], mesh, fn)
        with torch.no_grad():
            out[name] = gen(*gen_inputs(n), SEEDS[:n]).numpy()
    return out


def jax_batch(step: int) -> dict:
    """The JAX comparison's batch: the global batch with its injected draws
    (timesteps and corruption uniforms for the D3PM, levels for the NAR)."""
    b = global_batch(step)
    rs = np.random.RandomState(200 + step)
    b["t"] = rs.randint(1, DIT["timesteps"], B)
    b["q_noise"] = rs.rand(B, DIT["resp_len"], DIT["n_classes"]).astype(np.float32)
    b["quant_levels"] = rs.randint(0, 7, B)
    return b


def injected_loss(family: str):
    def fn(module, batch, generator, rows=None):
        if family == "d3pm":
            return module.loss(batch, None, t=batch["t"], q_noise=batch["q_noise"], rows=rows)
        _, losses = module(batch["text"], batch["text_mask"], batch["proms"],
                           batch["prom_mask"], batch["resps"], batch["resp_mask"],
                           batch["quant_levels"], rows=rows)
        return losses["nll"], losses

    return fn


def jax_run(mesh, ckpt_root, family: str, steps: int = 2):
    """The port's side of the JAX comparison: dropout off, injected draws."""
    engine = Engine("model", build(family, dropout=0.0), injected_loss(family), opt_cfg(),
                    ckpt_root, mesh=mesh)
    losses = [engine.train_batch(shard_batch(jax_batch(s), mesh), None)["model.loss"]
              for s in range(steps)]
    return engine, losses


def save_tensors(path: Path, tensors: dict) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in tensors.items()})


# ---------------- the ranks ----------------

def run_world4(out: Path) -> None:
    """Every world-4 scenario; rank 0 writes the full tensors, each rank its
    digests."""
    from tts_with_diffusion_model_tpu_torch.export import bundle_params, save_bundle
    from tts_with_diffusion_model_tpu_torch.utils import distributed

    rank = distributed.global_rank()
    lead = rank == 0
    record: dict = {"rank": rank}
    mesh22 = build_mesh(2, 2)
    record["coords"] = mesh22.coords
    for family in FAMILIES:
        engine, losses, digests = train_run(family, mesh22, out / f"ck22_{family}")
        record[f"2x2 {family}"] = {"losses": losses, "digests": digests}
        full = engine.full_state_dict()
        if lead:
            save_tensors(out / f"2x2_{family}.npz", full)
        if family == "d3pm":  # the export of the trained 2x2 engine (params and EMA)
            for what, tensors in (("raw", full), ("ema", engine.ema_state_dict())):
                flat = bundle_params(engine.module, tensors)
                if lead:
                    save_bundle(out / f"bundle_2x2_{what}", flat, {"model": "diffusion"},
                                {"a": 1}, {"s": 0})
            engine.save_checkpoint()
    # a seeded 2x2 engine's bundle, no training
    fresh = Engine("model", build("d3pm"), loss_fn("d3pm"), opt_cfg(), out / "unused",
                   mesh=mesh22)
    flat = bundle_params(fresh.module, fresh.full_state_dict())
    if lead:
        save_bundle(out / "bundle_2x2_seeded", flat, {"model": "diffusion"}, {"a": 1}, {"s": 0})
    for family in ("d3pm", "nar"):
        engine, losses = jax_run(mesh22, out / "unused", family)
        record[f"jax {family}"] = losses
        full = engine.full_state_dict()
        if lead:
            save_tensors(out / f"jax_{family}.npz", full)
    # checkpoints across a mesh reshape: dp=4 -> 2x2 -> dp=4
    mesh4 = build_mesh(4, 1)
    a, _, _ = train_run("d3pm", mesh4, out / "ckA", steps=2, zero1=True)
    a.save_checkpoint()
    b = Engine("model", build("d3pm"), loss_fn("d3pm"), opt_cfg(), out / "ckA",
               ema_decay=0.9, mesh=mesh22, zero1=True)
    b.load_checkpoint()
    a_to_b = state_diff(a._state(), b._state())  # before either steps: _state() holds views
    a, la, _ = train_run("d3pm", mesh4, None, steps=1, engine=a)
    b, lb, _ = train_run("d3pm", mesh22, None, steps=1, engine=b)
    b.ckpt_root = out / "ckB"
    b.save_checkpoint()
    c = Engine("model", build("d3pm"), loss_fn("d3pm"), opt_cfg(), out / "ckB",
               ema_decay=0.9, mesh=mesh4, zero1=True)
    c.load_checkpoint()
    b_to_c = state_diff(b._state(), c._state())
    full_a, full_b = a.full_state_dict(), b.full_state_dict()
    if lead:
        record["reshape"] = {"a->b": a_to_b, "b->c": b_to_c, "next step": [la, lb]}
        save_tensors(out / "reshape_dp4.npz", full_a)
        save_tensors(out / "reshape_2x2.npz", full_b)
    for name, codes in sample_all(mesh22).items():
        record[f"codes 2x2 {name}"] = codes.tolist()
    (out / f"rank{rank}.json").write_text(json.dumps(record))


def state_diff(x, y, path: str = "") -> list[str]:
    """The paths where two checkpoint states differ (tensor for tensor)."""
    if isinstance(x, dict):
        if x.keys() != y.keys():
            return [f"{path} keys"]
        return [d for k in x for d in state_diff(x[k], y[k], f"{path}/{k}")]
    if isinstance(x, (list, tuple)):
        if len(x) != len(y):
            return [f"{path} length"]
        return [d for i, (a, b) in enumerate(zip(x, y)) for d in state_diff(a, b, f"{path}[{i}]")]
    if isinstance(x, torch.Tensor):
        same = x.shape == y.shape and torch.equal(x.cpu(), y.cpu())
        return [] if same else [path]
    return [] if x == y else [path]


#: the largest learning rate of ``opt_cfg``
MAX_LR = 1e-3


def assert_params_close(got: dict, ref: dict, steps: int = STEPS) -> None:
    """Every parameter within ``PARAM_TOL``·max(1, |ref|), except the DiT's
    attention key biases: their gradient is zero in exact arithmetic
    (softmax does not see a per-row constant), so Adam turns the rounding
    noise of either side into steps of up to ±lr, and they are held to
    2·lr·steps."""
    key_bias = {k for k in ref if k.endswith(".k.bias")}
    assert max_rel_diff(got, {k: v for k, v in ref.items() if k not in key_bias}) <= PARAM_TOL
    for k in key_bias:
        assert np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max() <= 2 * MAX_LR * steps, k


def max_rel_diff(got: dict, ref: dict) -> float:
    """max over parameters of max|got − ref| / max(1, max|ref|)."""
    out = 0.0
    for k, r in ref.items():
        r = torch.as_tensor(np.asarray(r)).float()
        g = torch.as_tensor(np.asarray(got[k])).float()
        out = max(out, float((g - r).abs().max()) / max(1.0, float(r.abs().max())))
    return out


def worker_main(argv) -> int:
    """``python tests/test_torch_parallel.py <world4|world2> <out dir>``
    under torchrun's environment."""
    suite, out = argv[0], Path(argv[1])
    torch.set_num_threads(1)
    from tts_with_diffusion_model_tpu_torch.utils import distributed

    assert distributed.init_distributed("cpu")
    if suite == "world4":
        run_world4(out)
    else:
        sys.path.insert(0, str(Path(__file__).parent))
        import test_torch_distributed

        test_torch_distributed.run_world2(out)
    assert not any(m == "jax" or m.startswith(("jax.", "flax", "tts_with_diffusion_model_tpu."))
                   for m in sys.modules), "a rank imported JAX"
    distributed.barrier()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Launch:
    """``world`` ranks started with torchrun's environment; ``wait()`` waits
    for all of them (once), kills every one on a timeout or a failure, and
    raises with the failed ranks' logs.  Started at once, so the pytest
    process computes its references while the ranks run."""

    def __init__(self, suite: str, world: int, out: Path, timeout: float = CHILD_TIMEOUT_S):
        self.out, self.timeout, self.error = out, timeout, None
        self.procs = _start(suite, world, out)
        self.done = False

    def wait(self) -> Path:
        if not self.done:
            self.done = True
            try:
                _wait(self.procs, self.out, self.timeout)
            except RuntimeError as e:
                self.error = e
        if self.error is not None:
            raise self.error
        return self.out


def launch(suite: str, world: int, out: Path, timeout: float = CHILD_TIMEOUT_S) -> None:
    Launch(suite, world, out, timeout).wait()


def _start(suite: str, world: int, out: Path):
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        env.pop("XLA_FLAGS", None)
        log = open(out / f"log{rank}.txt", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, suite, str(out)], env=env,
                                       cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                       start_new_session=True), log))
    return procs


def _wait(procs, out: Path, timeout: float) -> None:
    """Until every rank exits 0, one fails, or the timeout; then kill the
    rest (a rank blocked in a collective with a dead peer never returns)."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            log.close()
    failed = [rank for rank, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        logs = "\n".join((out / f"log{r}.txt").read_text()[-3000:] for r in failed)
        raise RuntimeError(f"ranks {failed} failed:\n{logs}")


# ---------------- the tests ----------------

@pytest.fixture(scope="module")
def world4_ranks(tmp_path_factory):
    """The world-4 ranks, started when the module's first test asks."""
    out = tmp_path_factory.mktemp("world4")
    launched = Launch("world4", 4, out)
    yield launched
    try:
        launched.wait()
    except RuntimeError:
        pass


@pytest.fixture
def world4(world4_ranks):
    out = world4_ranks.wait()
    return out, [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]


@pytest.fixture(scope="module")
def one_by_one(tmp_path_factory):
    """The port's 1×1 runs of every family (this process)."""
    out = tmp_path_factory.mktemp("one_by_one")
    mesh = build_mesh(1, 1)
    runs = {}
    for family in FAMILIES:
        engine, losses, _ = train_run(family, mesh, out / family)
        runs[family] = (losses, {k: v.numpy().copy() for k, v in engine.full_state_dict().items()})
    return runs


def _jax_side(family: str, tmp_path):
    """JAX's ``Engine`` on ``build_mesh(2, 2)`` of the 8 virtual devices,
    from the port's seeded weights, 2 steps on the injected draws →
    (losses, flat parameters under the port's names)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JCfg
    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JModel
    from tts_with_diffusion_model_tpu.models.nar import NAR as JNAR
    from tts_with_diffusion_model_tpu.parallel.mesh import build_mesh as jax_mesh
    from tts_with_diffusion_model_tpu.train.engine import Engine as JEngine
    from tts_with_diffusion_model_tpu_torch.convert import (jax_params_to_torch,
                                                            torch_params_to_jax)

    from torch_port_helpers import flatten, unflatten

    port = build(family, dropout=0.0)
    root = getattr(port, "denoiser", port)
    flat = {f"params/{k}": v for k, v in torch_params_to_jax(root).items()}
    b0 = jax_batch(0)
    if family == "d3pm":
        jm = JModel(JCfg(**DIT, **TINY), dtype=jnp.float32)
        boxed = jm.denoiser.init(jax.random.PRNGKey(0), jnp.asarray(b0["text"]),
                                 jnp.asarray(b0["text_mask"]), jnp.asarray(b0["proms"]),
                                 jnp.asarray(b0["prom_mask"]), jnp.asarray(b0["resp"]),
                                 jnp.asarray(b0["resp_mask"]), jnp.asarray(b0["t"]))

        def jloss(p, b, rng):
            den = jm.denoiser
            text_cond, spkr_cond = den.apply(p, b["text"], b["text_mask"], b["proms"],
                                             b["prom_mask"], method=den.conds)
            x_t = (jm.d3pm.q_sample(b["resp"], b["t"], uniform_noise=b["q_noise"])
                   * b["resp_mask"]).astype(jnp.int32)
            logits = den.apply(p, x_t, b["resp_mask"], b["t"], text_cond, b["text_mask"],
                               spkr_cond, b["prom_mask"], method=den.denoise)
            logp = jax.nn.log_softmax(logits, axis=-1)
            nll = -jnp.take_along_axis(logp, b["resp"][..., None], axis=-1)[..., 0]
            loss = (nll * b["resp_mask"]).sum() / jnp.maximum(b["resp_mask"].sum(), 1.0)
            return loss, {}
    else:
        jm = JNAR(V, p_dropout=0.0, remat=True, dtype=jnp.float32, **TINY)
        boxed = jm.init(jax.random.PRNGKey(0), jnp.asarray(b0["text"]),
                        jnp.asarray(b0["text_mask"]), jnp.asarray(b0["proms"]),
                        jnp.asarray(b0["prom_mask"]), jnp.asarray(b0["resps"]),
                        jnp.asarray(b0["resp_mask"]), jnp.asarray(b0["quant_levels"]))

        def jloss(p, b, rng):
            _, losses = jm.apply(p, b["text"], b["text_mask"], b["proms"], b["prom_mask"],
                                 b["resps"], b["resp_mask"], b["quant_levels"])
            return losses["nll"], {}

    values = unflatten(flat)
    boxed = jax.tree.map(
        lambda box, v: box.replace_boxed(jnp.asarray(v)) if isinstance(box, nn.Partitioned)
        else jnp.asarray(v), boxed, values, is_leaf=lambda x: isinstance(x, nn.Partitioned))
    mesh = jax_mesh(2, 2)
    engine = JEngine("model", boxed, jloss, opt_cfg(), tmp_path, mesh=mesh)
    assert engine.param_sharding is not None
    losses = []
    for s in range(2):
        b = {k: np.asarray(v, np.int32 if v.dtype.kind == "i" else np.float32)
             for k, v in jax_batch(s).items()}
        losses.append(engine.train_batch(b, jax.random.PRNGKey(s))["model.loss"])
    got = flatten(jax.device_get(engine.params))
    holder = build(family, dropout=0.0)
    jax_params_to_torch(got, getattr(holder, "denoiser", holder))
    return losses, {k: v.detach().numpy() for k, v in holder.state_dict().items()}


@pytest.mark.parametrize("family", ["d3pm", "nar"])
def test_2x2_train_step_matches_jax_2x2_engine(world4_ranks, family, tmp_path):
    """The port's 2×2 step against JAX's 2×2 ``Engine``: same weights, same
    batch, same injected draws, dropout off (``assert_params_close``).  JAX
    compiles while the ranks run."""
    ref_losses, ref = _jax_side(family, tmp_path)
    out = world4_ranks.wait()
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(4)]
    np.testing.assert_allclose(ranks[0][f"jax {family}"], ref_losses, rtol=1e-5)
    assert_params_close(dict(np.load(out / f"jax_{family}.npz")), ref, steps=2)


@pytest.mark.parametrize("family", FAMILIES)
def test_2x2_training_equals_1x1(world4, one_by_one, family):
    out, ranks = world4
    ref_losses, ref = one_by_one[family]
    got = dict(np.load(out / f"2x2_{family}.npz"))
    np.testing.assert_allclose(ranks[0][f"2x2 {family}"]["losses"], ref_losses, rtol=1e-5)
    assert_params_close(got, ref)


@pytest.mark.parametrize("family", FAMILIES)
def test_2x2_params_bit_identical_across_each_dp_group(world4, family):
    _, ranks = world4
    by_tp = {}
    for r in ranks:
        by_tp.setdefault(r["coords"][1], []).append(r[f"2x2 {family}"]["digests"])
    assert len(by_tp) == 2
    for group in by_tp.values():
        assert len(group) == 2 and group[0] == group[1]


def test_checkpoints_restore_across_a_mesh_reshape(world4):
    """Saved at dp=4 (ZeRO-1, EMA), restored at 2×2: params, moments, EMA
    and the step identical, and one more step matches; saved at 2×2 and
    restored at dp=4 the same."""
    out, ranks = world4
    r = ranks[0]["reshape"]
    assert r["a->b"] == [] and r["b->c"] == []
    np.testing.assert_allclose(r["next step"][1], r["next step"][0], rtol=1e-5)
    assert_params_close(dict(np.load(out / "reshape_2x2.npz")),
                        dict(np.load(out / "reshape_dp4.npz")), steps=1)


def _bundle_bytes(path: Path) -> dict:
    with np.load(path / "params.npz") as z:
        return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}


def _export_1x1(tensors, path):
    from tts_with_diffusion_model_tpu_torch.export import bundle_params, save_bundle

    model = build("d3pm")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in tensors.items()})
    save_bundle(path, bundle_params(model, None if tensors is None else
                                    {k: torch.as_tensor(v) for k, v in tensors.items()}),
                {"model": "diffusion"}, {"a": 1}, {"s": 0})
    return model


def test_2x2_export_is_the_1x1_bundle_byte_for_byte(world4, tmp_path):
    """The bundle a 2×2 engine writes (its params gathered, and its EMA)
    equals, array for array and byte for byte, the one a 1×1 engine
    holding the same weights writes: a seeded engine, and the trained one
    restored from its own mesh-agnostic checkpoint."""
    out, _ = world4
    seeded = build("d3pm")
    _export_1x1({k: v.numpy() for k, v in seeded.state_dict().items()}, tmp_path / "seeded")
    assert _bundle_bytes(out / "bundle_2x2_seeded") == _bundle_bytes(tmp_path / "seeded")
    state = torch.load(next((out / "ck22_d3pm" / "model").glob("step_*.pt")), weights_only=True)
    names = [n for n, _ in build("d3pm").named_parameters()]
    ema = dict(zip(names, state["ema"]))
    for what, tensors in (("raw", state["params"]), ("ema", ema)):
        full = dict(state["params"], **tensors)
        _export_1x1({k: v.numpy() for k, v in full.items()}, tmp_path / what)
        assert _bundle_bytes(out / f"bundle_2x2_{what}") == _bundle_bytes(tmp_path / what)


def test_2x2_bundle_loads_in_jax_with_the_ports_logits(world4):
    """JAX's ``export.load_bundle`` reads the 2×2 engine's bundle, and its
    denoiser gives the port's logits within 1e-4·max(1, |ref|)."""
    import jax.numpy as jnp

    from tts_with_diffusion_model_tpu.export import load_bundle
    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JCfg
    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JModel

    out, _ = world4
    params, meta, _, _ = load_bundle(out / "bundle_2x2_raw")
    assert meta["model"] == "diffusion"
    port = build("d3pm")
    port.load_state_dict({k: torch.as_tensor(v) for k, v in
                          np.load(out / "2x2_d3pm.npz").items()})
    b = global_batch(0)
    t = np.array([1, 2, 3, 5])
    with torch.no_grad():
        ref = port.denoiser(*[torch.as_tensor(b[k]) for k in
                              ("text", "text_mask", "proms", "prom_mask", "resp", "resp_mask")],
                            torch.as_tensor(t)).numpy()
    jm = JModel(JCfg(**DIT, **TINY), dtype=jnp.float32)
    got = np.asarray(jm.denoiser.apply(
        params, *[jnp.asarray(b[k].astype(np.int32) if b[k].dtype.kind == "i" else b[k])
                           for k in ("text", "text_mask", "proms", "prom_mask", "resp",
                                     "resp_mask")], jnp.asarray(t, jnp.int32)))
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def single_codes():
    return sample_all(build_mesh(1, 1))


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_2x2_sharded_generate_codes_equal_one_process(world4, single_codes, sampler):
    _, ranks = world4
    for r in ranks:  # replicated on every rank
        np.testing.assert_array_equal(np.asarray(r[f"codes 2x2 {sampler}"]),
                                      single_codes[sampler])


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
