"""The port's ancestral D3PM sampler against the JAX package's, in fp32 on
the CPU: every process method of ``D3PM`` on random inputs for the absorbing
and uniform families, with rows at t = 0, 1, a middle step and T−1 (logits
within 1e-5, samples identical under the same uniforms); the dense
``from_matrices`` family on slices of the committed fixture
``tests/fixtures/oracle_d3pm_mats.npz``; ``DiffusionModel.generate`` on a
tiny DiT at stride 1 and 3 under injected uniforms (JAX's ``row_uniform`` /
``fold_rows`` patched to read a numpy table keyed by the process timestep);
and, inside the port, per-row cohort independence and tight-bucket
equality."""

import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tts_with_diffusion_model_tpu.models.diffusion as jax_diffusion
from tts_with_diffusion_model_tpu.diffusion.d3pm import D3PM as JaxD3PM
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JaxConfig
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxDiffusion
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch
from tts_with_diffusion_model_tpu_torch.diffusion.d3pm import D3PM
from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig, DiffusionModel
from tts_with_diffusion_model_tpu_torch.utils.rng import RowKeys

from torch_port_helpers import (  # noqa: F401 (one_thread: fixture)
    TableKeys,
    one_thread,
    patch_jax_noise,
    perturbed,
    t,
    unflatten,
)

#: tiny models only: one intra-op thread each
pytestmark = pytest.mark.usefixtures("one_thread")

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "oracle_d3pm_mats.npz"
ATOL = 1e-5
T_STEPS, V, W = 20, 65, 12
#: one row each at t = 0, 1, a middle step and T−1, with the strided
#: targets s < t (s = −1 is the interval from before the first step)
TS = np.array([0, 1, 7, T_STEPS - 1])
SS = np.array([-1, 0, 3, 16])
FAMILIES = ["absorbing", "uniform"]


def _pair(transition):
    return (D3PM.create(T_STEPS, V, transition=transition),
            JaxD3PM.create(T_STEPS, V, transition=transition))


def _inputs(seed, absorb=V // 2):
    rs = np.random.RandomState(seed)
    B = len(TS)
    x_t = rs.randint(0, V, (B, W))
    x_t[:, ::3] = absorb  # absorbed positions in every row
    x0 = rs.randint(0, V, (B, W))
    logits = (3 * rs.randn(B, W, V)).astype(np.float32)
    noise = rs.uniform(size=(B, W, V)).astype(np.float32)
    noise[0, 0, :4] = 0.0  # clamped to the smallest normal float
    return x_t, x0, logits, noise


def _close(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=ATOL, err_msg=what)


def test_create_matches_and_constants_are_fp32():
    for transition in FAMILIES:
        port, ref = _pair(transition)
        for name in ("betas", "cum_diag", "cum_off"):
            np.testing.assert_array_equal(getattr(port, name), np.asarray(getattr(ref, name)))
        assert port._const("cum_diag", "cpu").dtype == torch.float32


@pytest.mark.parametrize("transition", FAMILIES)
def test_dense_views_and_row_helpers_match(transition):
    port, ref = _pair(transition)
    x_t, _, logits, _ = _inputs(1)
    tt, jt = torch.from_numpy(TS), jnp.asarray(TS)
    _close(port.q_onestep_mats, ref.q_onestep_mats, "q_onestep_mats")
    _close(port.q_mats, ref.q_mats, "q_mats")
    _close(port.transpose_q_onestep_mats, ref.transpose_q_onestep_mats, "transpose")
    np.testing.assert_array_equal(port._structured_mats(True), ref._structured_mats(True))
    _close(port._cum_row(tt, t(x_t)), ref._cum_row(jt, jnp.asarray(x_t)), "_cum_row")
    p = torch.softmax(t(logits), -1)
    _close(port._cum_mix(tt, p), ref._cum_mix(jt, jnp.asarray(p.numpy())), "_cum_mix")
    _close(port._onestep_T_row(tt, t(x_t)), ref._onestep_T_row(jt, jnp.asarray(x_t)),
           "_onestep_T_row")
    mats = port.q_mats
    _close(port._at(mats, tt, t(x_t)), ref._at(ref.q_mats, jt, jnp.asarray(x_t)), "_at")
    _close(port._at_onehot(mats, tt, p), ref._at_onehot(ref.q_mats, jt, jnp.asarray(p.numpy())),
           "_at_onehot")
    _close(port._interval_diag(torch.from_numpy(SS), tt),
           ref._interval_diag(jnp.asarray(SS), jt), "_interval_diag")


@pytest.mark.parametrize("transition", FAMILIES)
def test_posteriors_match(transition):
    port, ref = _pair(transition)
    x_t, x0, logits, _ = _inputs(2)
    tt, jt = torch.from_numpy(TS), jnp.asarray(TS)
    jx_t = jnp.asarray(x_t)
    for as_logits, x_start in ((True, logits), (False, x0)):
        got = port.q_posterior_logits(t(x_start), t(x_t), tt, x_start_logits=as_logits)
        want = ref.q_posterior_logits(jnp.asarray(x_start), jx_t, jt, x_start_logits=as_logits)
        assert got.dtype == torch.float32
        _close(got, want, f"q_posterior_logits x_start_logits={as_logits}")
        if as_logits:  # t == 0 returns the x_0 logits untouched
            np.testing.assert_array_equal(got[0].numpy(), logits[0])
    got, pred = port.p_logits(t(logits).to(torch.bfloat16), tt, t(x_t))
    assert got.dtype == pred.dtype == torch.float32  # the posterior runs in fp32
    want, _ = ref.p_logits(jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32), jt, jx_t)
    _close(got, want, "p_logits")
    ss = np.maximum(SS, 0)
    got = port.q_posterior_logits_strided(t(logits), t(x_t), tt, torch.from_numpy(ss))
    _close(got, ref.q_posterior_logits_strided(jnp.asarray(logits), jx_t, jt, jnp.asarray(ss)),
           "q_posterior_logits_strided")
    # at s = t − 1 the strided posterior is the one-step one
    one = np.maximum(TS - 1, 0)
    got = port.q_posterior_logits_strided(t(logits), t(x_t), tt, torch.from_numpy(one))
    _close(got, port.q_posterior_logits(t(logits), t(x_t), tt, True), "stride 1")


@pytest.mark.parametrize("transition", FAMILIES)
def test_samples_identical_under_the_same_uniforms(transition):
    port, ref = _pair(transition)
    x_t, x0, logits, noise = _inputs(3)
    tt, jt = torch.from_numpy(TS), jnp.asarray(TS)
    ss = np.maximum(SS, 0)
    args = (t(logits), tt, t(x_t))
    jargs = (jnp.asarray(logits), jt, jnp.asarray(x_t))
    cases = {
        "q_sample": (port.q_sample(t(x0), tt, uniform_noise=t(noise)),
                     ref.q_sample(jnp.asarray(x0), jt, uniform_noise=jnp.asarray(noise))),
        "p_sample": (port.p_sample(*args, uniform_noise=t(noise)),
                     ref.p_sample(*jargs, uniform_noise=jnp.asarray(noise))),
        "p_sample_strided": (
            port.p_sample_strided(t(logits), tt, torch.from_numpy(ss), t(x_t),
                                  uniform_noise=t(noise)),
            ref.p_sample_strided(jnp.asarray(logits), jt, jnp.asarray(ss), jnp.asarray(x_t),
                                 uniform_noise=jnp.asarray(noise))),
    }
    for name, (got, want) in cases.items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    # no noise at t == 0: the row is the argmax of the x_0 logits
    got = port.p_sample(*args, uniform_noise=t(noise))
    np.testing.assert_array_equal(got[0].numpy(), logits[0].argmax(-1))
    with pytest.raises(ValueError, match="uniform_noise or a generator"):
        port.p_sample(*args)
    g = torch.Generator().manual_seed(0)
    assert port.p_sample(*args, generator=g).shape == (len(TS), W)


def _fixture_slices(name: str, ts) -> np.ndarray:
    """Slices ``[ts]`` of a (T, V, V) array in the fixture npz, read from the
    compressed member one slice at a time (the whole array is 210 MB)."""
    with zipfile.ZipFile(FIXTURE) as z, z.open(f"{name}.npy") as f:
        version = np.lib.format.read_magic(f)
        shape, fortran, dtype = np.lib.format._read_array_header(f, version)
        assert not fortran and len(shape) == 3
        per = shape[1] * shape[2] * dtype.itemsize
        out, pos = [], 0
        for want in sorted(ts):
            while pos < want:
                f.read(per)
                pos += 1
            out.append(np.frombuffer(f.read(per), dtype).reshape(shape[1:]))
            pos += 1
    order = np.argsort(np.argsort(ts))
    return np.stack([out[i] for i in order]).astype(np.float32)


@pytest.fixture(scope="module")
def fixture_mats():
    if not FIXTURE.exists():
        pytest.skip("tests/fixtures/oracle_d3pm_mats.npz is not in this checkout")
    ts = [0, 1, 2, 49, 50, 98, 99]
    with np.load(FIXTURE) as z:
        betas = z["betas"].astype(np.float32)
    return ts, betas, _fixture_slices("q_onestep_mats", ts), _fixture_slices("q_mats", ts)


def test_dense_from_matrices_matches_jax_and_the_fixture(fixture_mats):
    ts, betas, onestep, cum = fixture_mats
    port = D3PM.from_matrices(betas[:3], onestep[:3])
    ref = JaxD3PM.from_matrices(betas[:3], onestep[:3])
    assert port.transition == "dense" and (port.timesteps, port.num_classes) == (3, 1025)
    np.testing.assert_allclose(port.q_mats.numpy(), np.asarray(ref.q_mats), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(port.q_onestep_mats.numpy(), np.asarray(ref.q_onestep_mats))
    # the fixture's cumulative products were taken in fp16
    np.testing.assert_allclose(port.q_mats.numpy(), cum[:3], rtol=0, atol=2e-3)


def test_dense_posterior_and_samples_match_jax(fixture_mats):
    """Stacks of the slices (0, 1, 49, 50, 98, 99): index i of the one-step
    stack and i−1 of the cumulative one are process steps t and t−1, so rows
    at indices 0, 1, 3, 5 are the process's t = 0, 1, 50, 99."""
    ts, betas, onestep, cum = fixture_mats
    keep = [0, 1, 3, 4, 5, 6]  # drop t = 2
    kw = dict(timesteps=len(keep), num_classes=1025, transition="dense",
              betas=betas[[ts[i] for i in keep]])
    port = D3PM(**kw, q_onestep=onestep[keep], q_cum=cum[keep])
    ref = JaxD3PM(**kw, _q_onestep=jnp.asarray(onestep[keep]), _q_cum=jnp.asarray(cum[keep]))
    rs = np.random.RandomState(4)
    idx = np.array([0, 1, 3, 5])
    x_t = rs.randint(0, 1025, (4, 8))
    x_t[:, ::2] = 512
    x0 = rs.randint(0, 1025, (4, 8))
    logits = (3 * rs.randn(4, 8, 1025)).astype(np.float32)
    noise = rs.uniform(size=(4, 8, 1025)).astype(np.float32)
    tt, jt = torch.from_numpy(idx), jnp.asarray(idx)
    _close(port.q_probs(t(x0), tt), ref.q_probs(jnp.asarray(x0), jt), "dense q_probs")
    for as_logits, x_start in ((True, logits), (False, x0)):
        _close(port.q_posterior_logits(t(x_start), t(x_t), tt, as_logits),
               ref.q_posterior_logits(jnp.asarray(x_start), jnp.asarray(x_t), jt, as_logits),
               f"dense q_posterior_logits x_start_logits={as_logits}")
    np.testing.assert_array_equal(
        port.q_sample(t(x0), tt, uniform_noise=t(noise)).numpy(),
        np.asarray(ref.q_sample(jnp.asarray(x0), jt, uniform_noise=jnp.asarray(noise))))
    np.testing.assert_array_equal(
        port.p_sample(t(logits), tt, t(x_t), uniform_noise=t(noise)).numpy(),
        np.asarray(ref.p_sample(jnp.asarray(logits), jt, jnp.asarray(x_t),
                                uniform_noise=jnp.asarray(noise))))
    with pytest.raises(ValueError, match="structured"):
        port.p_sample_strided(t(logits), tt, tt, t(x_t), uniform_noise=t(noise))


CFG = dict(n_classes=65, d_model=32, n_heads=2, n_layers=2, timesteps=20,
           resp_len=48, text_len=10, prom_len=16, gen_len=40)
B = 2


def _cond_batch(seed=0):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, 60, (B, CFG["text_len"]))
    tm = np.ones((B, CFG["text_len"]), np.float32)
    tm[1, 6:] = 0
    proms = rs.randint(0, 64, (B, CFG["prom_len"], 8))
    pm = np.ones((B, CFG["prom_len"]), np.float32)
    pm[0, 11:] = 0
    return text, tm, proms, pm


@pytest.fixture(scope="module")
def dit_pair():
    jm = JaxDiffusion(JaxConfig(**CFG), dtype=jnp.float32)
    flat = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0)), seed=5)
    pm = DiffusionModel(DiffusionConfig(**CFG), dtype=torch.float32)
    jax_params_to_torch(flat, pm.denoiser)
    return jm, unflatten(flat), pm


@pytest.mark.parametrize("stride", [1, 3])
def test_generate_tokens_identical_under_injected_uniforms(monkeypatch, dit_pair, stride):
    jm, jp, pm = dit_pair
    bucket = CFG["resp_len"]
    steps = list(range(CFG["timesteps"] - 1, 0, -stride))
    assert len(steps) == (19 if stride == 1 else 7)
    rs = np.random.RandomState(11 + stride)
    tables = {(ti, 2): rs.uniform(size=(B, bucket, CFG["n_classes"])).astype(np.float32)
              for ti in steps}
    patch_jax_noise(monkeypatch, jax_diffusion, tables)
    batch = _cond_batch(1)
    ref = np.asarray(jm.generate(jp, *[jnp.asarray(a) for a in batch],
                                 jnp.zeros((B, 2), jnp.uint32), stride=stride,
                                 resp_bucket=bucket))
    got = pm.generate(*[t(a) for a in batch], TableKeys(tables), stride=stride,
                      resp_bucket=bucket).numpy()
    assert got.shape == ref.shape == (B, bucket)
    np.testing.assert_array_equal(got, ref)
    assert (got[:, CFG["gen_len"]:] == 0).all()


def test_generate_rows_are_cohort_independent_and_buckets_agree(dit_pair):
    """A row's tokens depend only on its own key, and the tight bucket (the
    smallest covering gen_len) gives the full bucket's valid tokens."""
    _, _, pm = dit_pair
    text, tm, proms, prm = (t(a) for a in _cond_batch(2))
    gl = CFG["gen_len"]
    both = pm.generate(text, tm, proms, prm, RowKeys.from_seeds([4, 9]), stride=3)
    alone = pm.generate(text[1:], tm[1:], proms[1:], prm[1:], RowKeys.from_seeds([9]), stride=3)
    np.testing.assert_array_equal(both[1].numpy(), alone[0].numpy())
    assert not torch.equal(both[0], both[1])
    tight = pm.generate(text, tm, proms, prm, RowKeys.from_seeds([4, 9]), stride=3,
                        resp_bucket=gl)
    np.testing.assert_array_equal(tight.numpy(), both[:, :gl].numpy())
    with pytest.raises(ValueError, match="resp_bucket"):
        pm.generate(text, tm, proms, prm, RowKeys.from_seeds([4, 9]), resp_bucket=gl - 1)
