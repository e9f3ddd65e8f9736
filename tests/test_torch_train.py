"""The port's training runtime against the JAX package's, on the CPU:

- three ``Engine`` steps against three optax steps (``make_optimizer``:
  clip by global norm + Adam at WarmupDecayLR, with ``MultiSteps`` under
  gradient accumulation) and the JAX engine's EMA, on the same weights,
  batch and injected noise — parameters, EMA, the lr sequence and grad_norm;
- the Python data loader's batches, identical to the JAX package's Python
  loader on a seeded corpus, with and without length buckets;
- the train CLI with ``device=cpu`` driven through stdin (``save``, then
  ``quit``), and a second run resuming from the saved step."""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from tts_with_diffusion_model_tpu.config import Config as JaxConfig
from tts_with_diffusion_model_tpu.data.dataset import (
    BucketSpec as JaxBucket,
)
from tts_with_diffusion_model_tpu.data.dataset import (
    create_train_val_dataloader as jax_loaders,
)
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JaxCfg
from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JaxModel
from tts_with_diffusion_model_tpu.train.engine import make_optimizer
from tts_with_diffusion_model_tpu_torch import smoke_train
from tts_with_diffusion_model_tpu_torch.config import Config
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch, torch_params_to_jax
from tts_with_diffusion_model_tpu_torch.data.dataset import BucketSpec, create_train_val_dataloader
from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig, DiffusionModel
from tts_with_diffusion_model_tpu_torch.train import train as port_train
from tts_with_diffusion_model_tpu_torch.train.engine import Engine, Engines
from tts_with_diffusion_model_tpu_torch.train.trainer import StdinCommands

from torch_port_helpers import flatten, seeded_flax_params, small_codec, t, unflatten  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
KW = dict(n_classes=33, d_model=32, n_heads=2, n_layers=1, timesteps=6, resp_len=12,
          text_len=7, prom_len=9)
#: parameters and EMA after three updates at lr ≤ 1e-3 from identical
#: gradients: fp32 rounding of the two Adam formulas and EMA sums
PARAM_TOL = 1e-6
GRAD_NORM_RTOL = 1e-5
EMA = 0.9


def _batch(seed):
    rs = np.random.RandomState(seed)
    B = 2
    batch = dict(
        text=rs.randint(1, 33, (B, 7)).astype(np.int32), text_mask=np.ones((B, 7), np.float32),
        proms=rs.randint(0, 33, (B, 9, 8)).astype(np.int32), prom_mask=np.ones((B, 9), np.float32),
        resp=rs.randint(0, 32, (B, 12)).astype(np.int32), resp_mask=np.ones((B, 12), np.float32))
    batch["text_mask"][1, 5:] = 0
    batch["resp_mask"][0, 9:] = 0
    return batch


def _unprefixed(flat):
    return {k.removeprefix("denoiser/"): v for k, v in flat.items()}


def _opt_cfg(accum):
    return {"scheduler": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3, "warmup_num_steps": 2,
                          "total_num_steps": 10},
            "gradient_clipping": 1.0, "gradient_accumulation_steps": accum}


@functools.cache
def _jax_model():
    """The JAX model, its perturbed flat parameters and its jitted loss
    gradient on injected timesteps and noise (compiled once per module)."""
    jm = JaxModel(JaxCfg(**KW), dtype=jnp.float32)
    flat = seeded_flax_params(DiffusionModel(DiffusionConfig(**KW)).denoiser, seed=1)

    def jloss(p, b, tt, n):
        text_cond, spkr_cond = jm.denoiser.apply(p, b["text"], b["text_mask"], b["proms"],
                                                 b["prom_mask"], method=jm.denoiser.conds)
        x_t = (jm.d3pm.q_sample(b["resp"], tt, uniform_noise=n) * b["resp_mask"]).astype(jnp.int32)
        logits = jm.denoiser.apply(p, x_t, b["resp_mask"], tt, text_cond, b["text_mask"],
                                   spkr_cond, b["prom_mask"], method=jm.denoiser.denoise)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, b["resp"][..., None], axis=-1)[..., 0]
        return (nll * b["resp_mask"]).sum() / jnp.maximum(b["resp_mask"].sum(), 1.0)

    return flat, jax.jit(jax.value_and_grad(jloss))


@pytest.mark.parametrize("accum", [1, 2])
def test_three_engine_steps_match_optax(tmp_path, accum):
    flat, grad_fn = _jax_model()
    params = unflatten(flat)
    pm = DiffusionModel(DiffusionConfig(**KW), dtype=torch.float32)
    jax_params_to_torch(flat, pm.denoiser)

    n_steps = 3
    rs = np.random.RandomState(4)
    batches = [_batch(i) for i in range(n_steps)]
    ts = [rs.randint(1, KW["timesteps"], 2) for _ in range(n_steps)]
    noises = [rs.rand(2, 12, 33).astype(np.float32) for _ in range(n_steps)]

    # JAX: the JAX engine's step, written out (value_and_grad, global norm,
    # tx.update, apply_updates, EMA), with the timesteps fed through q_sample
    tx, schedule = make_optimizer(_opt_cfg(accum))
    state = tx.init(params)
    ema = jax.tree.map(jnp.copy, params)

    @jax.jit
    def update(grads, state, params, ema):
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        d = jnp.float32(EMA)
        return state, params, jax.tree.map(lambda e, p: d * e + (1.0 - d) * p, ema, params)

    ref_loss, ref_lr, ref_norm, ref_grads = [], [], [], []
    for i in range(n_steps):
        b = {k: jnp.asarray(v) for k, v in batches[i].items()}
        loss, grads = grad_fn(params, b, jnp.asarray(ts[i]), jnp.asarray(noises[i]))
        ref_loss.append(float(loss))
        ref_grads.append(flatten(grads))
        ref_norm.append(float(optax.global_norm(grads)))
        state, params, ema = update(grads, state, params, ema)
        ref_lr.append(float(schedule(i + 1)))

    # The port's loss on the same draws, carrying JAX's gradient as its own
    # (value: the port's loss; gradient: exactly JAX's, through the term
    # <p, g> − <p, g>.detach()), so the optimizer is compared on identical
    # inputs.  Adam maps a gradient element that is rounding noise (an
    # attention key bias: zero in exact arithmetic) to a ±lr step, so two
    # gradients equal to 1e-4 could still part by 2·lr there; the loss and
    # its gradient are held to JAX's in test_torch_train_loss.py.
    port_grads = []
    for g in ref_grads:  # JAX's gradients in the port's layout
        holder = DiffusionModel(DiffusionConfig(**KW), dtype=torch.float32)
        jax_params_to_torch(g, holder.denoiser)
        port_grads.append([x.detach() for x in holder.parameters()])
    calls = iter(range(n_steps))

    def loss_fn(module, batch, generator):
        i = next(calls)
        loss, stats = module.loss(batch, generator, q_noise=t(noises[i]), t=t(ts[i]))
        carry = sum((p * g).sum() for p, g in zip(module.parameters(), port_grads[i]))
        return loss.detach() + carry - carry.detach(), stats

    engine = Engine("model", pm, loss_fn, _opt_cfg(accum), tmp_path, ema_decay=EMA)
    stats = [engine.train_batch(batches[i], None) for i in range(n_steps)]
    np.testing.assert_allclose([s["model.loss"] for s in stats], ref_loss, rtol=1e-5)
    np.testing.assert_allclose([s["lr"] for s in stats], ref_lr, rtol=1e-6)
    np.testing.assert_allclose([s["grad_norm"] for s in stats], ref_norm, rtol=GRAD_NORM_RTOL)
    assert engine.step == n_steps and engine.update_count == n_steps // accum

    got = _unprefixed(torch_params_to_jax(pm))
    got_ema = _unprefixed(torch_params_to_jax(pm, engine.ema_state_dict()))
    for ref_tree, port in ((params, got), (ema, got_ema)):
        ref = {k.removeprefix("params/"): v for k, v in flatten(ref_tree).items()}
        assert set(ref) == set(port)
        for k, r in ref.items():
            np.testing.assert_allclose(port[k], r, atol=PARAM_TOL, err_msg=k)
    moved = max(float(np.abs(got[k] - flat[f"params/{k}"]).max()) for k in got)
    assert moved > 1e-4  # the updates were applied


def _not_text_emb(path):
    return "text_emb" not in path


@pytest.mark.parametrize("accum", [1, 2])
def test_trainable_filter_freezes_and_clips_over_the_trainable_only(tmp_path, accum):
    """``trainable_filter`` on the JAX path: with clipping active, three
    steps leave ``text_emb`` bit for bit and move the rest as optax's
    ``multi_transform`` over clip + Adam (under ``MultiSteps``) does, the
    clipping norm taken over the trainable gradients only; frozen
    parameters hold no Adam state."""
    flat, grad_fn = _jax_model()
    params = unflatten(flat)
    pm = DiffusionModel(DiffusionConfig(**KW), dtype=torch.float32)
    jax_params_to_torch(flat, pm.denoiser)
    opt_cfg = dict(_opt_cfg(accum), gradient_clipping=1e-3)
    rs = np.random.RandomState(6)
    batches = [_batch(i) for i in range(3)]
    ts = [rs.randint(1, KW["timesteps"], 2) for _ in range(3)]
    noises = [rs.rand(2, 12, 33).astype(np.float32) for _ in range(3)]

    tx, _ = make_optimizer(opt_cfg, params, _not_text_emb)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    ref_grads = []
    for i in range(3):
        b = {k: jnp.asarray(v) for k, v in batches[i].items()}
        _, grads = grad_fn(params, b, jnp.asarray(ts[i]), jnp.asarray(noises[i]))
        ref_grads.append(flatten(grads))
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
    trainable = {k: v for k, v in ref_grads[0].items() if _not_text_emb(k)}
    assert float(optax.global_norm(trainable)) > 1e-3  # the clip is active

    port_grads = []
    for g in ref_grads:
        holder = DiffusionModel(DiffusionConfig(**KW), dtype=torch.float32)
        jax_params_to_torch(g, holder.denoiser)
        port_grads.append([x.detach() for x in holder.parameters()])
    calls = iter(range(3))

    def loss_fn(module, batch, generator):
        i = next(calls)
        loss, stats = module.loss(batch, generator, q_noise=t(noises[i]), t=t(ts[i]))
        carry = sum((p * g).sum() for p, g in zip(module.parameters(), port_grads[i]))
        return loss.detach() + carry - carry.detach(), stats

    before = pm.denoiser.text_emb.weight.detach().clone()
    engine = Engine("model", pm, loss_fn, opt_cfg, tmp_path, trainable_filter=_not_text_emb)
    for i in range(3):
        engine.train_batch(batches[i], None)
    assert torch.equal(pm.denoiser.text_emb.weight, before)
    frozen = [p for p, keep in zip(engine.params, engine.trainable) if not keep]
    assert frozen == [pm.denoiser.text_emb.weight]
    assert all(id(p) not in {id(q) for q in frozen} for p in engine.optimizer.state)
    got = _unprefixed(torch_params_to_jax(pm))
    for k, r in flatten(params).items():
        np.testing.assert_allclose(got[k.removeprefix("params/")], r, atol=PARAM_TOL, err_msg=k)
    moved = max(float(np.abs(got[k] - flat[f"params/{k}"]).max()) for k in got)
    assert moved > 1e-4


def test_checkpoint_round_trip_and_retention(tmp_path):
    pm = DiffusionModel(DiffusionConfig(**KW), dtype=torch.float32)
    smoke_init = torch.Generator().manual_seed(0)
    for p in pm.parameters():
        p.data.normal_(generator=smoke_init)
    rs = np.random.RandomState(0)

    def loss_fn(module, batch, generator):
        return module.loss(batch, None, q_noise=t(rs.rand(2, 12, 33).astype(np.float32)),
                           t=torch.tensor([1, 2]))

    e = Engine("model", pm, loss_fn, _opt_cfg(2), tmp_path, ema_decay=EMA)
    for i in range(3):
        e.train_batch(_batch(i), None)
        e.save_checkpoint(keep=2)
    assert sorted(p.name for p in (tmp_path / "model").iterdir()) == [
        "step_00000002.pt", "step_00000003.pt"]
    fresh = Engine("model", DiffusionModel(DiffusionConfig(**KW), dtype=torch.float32), loss_fn,
                   _opt_cfg(2), tmp_path, ema_decay=EMA)
    assert fresh.load_checkpoint()
    assert (fresh.step, fresh.update_count, fresh.mini_step) == (3, 1, 1)
    for a, b in zip(e.params + e.ema + e.acc, fresh.params + fresh.ema + fresh.acc):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        fresh.load_checkpoint(step=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    smoke_train.write_train_corpus(root, n_speakers=3, n_utts=12, seed=0, frames=(10, 40),
                             phones=(3, 12))
    return root


def _cfg_kw(corpus, buckets):
    return dict(data_dirs=[corpus], spkr_name_getter="parts:-2", min_phones=3, batch_size=4,
                eval_batch_size=4, nj=1, max_num_val=6, use_native_loader=False,
                resp_len_buckets=buckets, prom_len_buckets=[64] if buckets else None,
                bucket_window_batches=3, max_prompts=3, seed=5)


@pytest.mark.parametrize("buckets", [None, [24]])
def test_python_loader_batches_are_identical_to_the_jax_loader(corpus, buckets):
    port = create_train_val_dataloader(Config(**_cfg_kw(corpus, buckets)), BucketSpec(16, 96, 48))
    ref = jax_loaders(JaxConfig(**_cfg_kw(corpus, buckets)), JaxBucket(16, 96, 48))
    for p_dl, r_dl, n in zip(port, ref, (6, None, None)):
        p_it, r_it = iter(p_dl), iter(r_dl)
        p_batches = [next(p_it) for _ in range(n)] if n else list(p_it)
        r_batches = [next(r_it) for _ in range(n)] if n else list(r_it)
        assert len(p_batches) == len(r_batches) > 0
        for pb, rb in zip(p_batches, r_batches):
            assert pb.keys() == rb.keys()
            for k in rb:
                if isinstance(rb[k], np.ndarray):
                    np.testing.assert_array_equal(pb[k], rb[k], err_msg=k)
                else:
                    assert [str(x) for x in pb[k]] == [str(x) for x in rb[k]], k
        p_it.close()
        r_it.close()


def _write_yaml(tmp_path, corpus, **extra):
    cfg = dict(cfg_name="tiny", data_dirs=[str(corpus)], spkr_name_getter="parts:-2", model="diffusion",
               model_overrides=dict(d_model=32, n_heads=2, n_layers=2, timesteps=8,
                                    resp_len=48, text_len=16, prom_len=64, gen_len=40),
               batch_size=2, eval_batch_size=4, max_iter=10, eval_every=100,
               save_ckpt_every=0, min_phones=3, max_num_val=4, nj=1, ema_decay=0.9,
               warmup_max_lr=1e-3, warmup_num_steps=2, log_root=str(tmp_path / "logs"),
               ckpt_root=str(tmp_path / "ckpts"), **extra)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _run_cli(yml, stdin, *argv):
    return subprocess.run(
        [sys.executable, "-m", "tts_with_diffusion_model_tpu_torch.train", f"yaml={yml}",
         "device=cpu", *argv], cwd=REPO, input=stdin, capture_output=True, text=True, timeout=300)


def _stats(out):
    return [json.loads(line[line.index("{"):]) for line in out.splitlines()
            if " - {" in line and '"global_step"' in line]


def test_train_cli_on_cpu_through_stdin_then_resume(tmp_path, corpus):
    yml = _write_yaml(tmp_path, corpus)
    # first line is read before the loop, then one per step: save at step 1,
    # quit (with save_on_quit) at step 2
    out = _run_cli(yml, "\nsave\nquit\n")
    assert out.returncode == 0, out.stderr[-3000:]
    steps = [s["global_step"] for s in _stats(out.stdout)]
    assert steps == [1, 2]
    assert all(np.isfinite(s["model.loss"]) and np.isfinite(s["grad_norm"])
               for s in _stats(out.stdout))
    ckpts = tmp_path / "ckpts" / "tiny" / "model"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_00000001.pt", "step_00000002.pt"]

    # closed stdin from the start: the loop neither blocks nor polls; it
    # resumes at step 2 and runs to max_iter=4, saving at 4 and evaluating
    out = _run_cli(yml, "", "max_iter=4", "save_ckpt_every=2", "eval_every=4", "eval_use_ema=true")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Restored checkpoint" in out.stdout and "(step 2)" in out.stdout
    assert [s["global_step"] for s in _stats(out.stdout)] == [3, 4]
    assert "Eval: {'loss'" in out.stdout
    assert (ckpts / "step_00000004.pt").exists()


@pytest.mark.parametrize("knob", ["eval_decode_audio=true", "profile_every=2", "zero1=true",
                                  "mesh_dp=4", "cache_dataloader=true",
                                  "gradient_checkpointing_policy=dots"])
def test_unported_knobs_are_rejected_by_name(tmp_path, corpus, knob, small_codec, monkeypatch):
    """A mesh larger than the world is refused with JAX's assertion text;
    ``zero1`` on a world of one trains (dp 1: nothing to split); the other
    knobs are ported and a two-step run with each does what JAX's does: hyp / ref
    wavs and ``metrics.json`` (the keys JAX's
    ``test_train_main_eval_decode_audio`` asserts), a parsable trace under
    ``profile/step_2``, the dataset cache file, the ``dots`` policy."""
    from tts_with_diffusion_model_tpu_torch.codec import encodec

    monkeypatch.chdir(tmp_path)  # the dataset cache is .cache/<cfg_name>
    monkeypatch.setattr(encodec, "load_codec", lambda *a, **kw: small_codec)
    cfg = Config.from_cli([f"yaml={_write_yaml(tmp_path, corpus)}", "device=cpu", knob,
                           "max_iter=2", "eval_every=2"])
    name = knob.split("=")[0]
    if name == "mesh_dp":
        with pytest.raises(AssertionError, match="mesh dp=4 x tp=1 needs 4 devices"):
            port_train.main(cfg)
        return
    engines = port_train.main(cfg)
    assert engines.global_step == 2
    if name == "zero1":
        assert engines["model"].zero1_dims is None and engines["model"].mesh.size == 1
    elif name == "eval_decode_audio":
        wavs = list(Path(cfg.log_dir).rglob("*.wav"))
        assert any("ref" in str(w) for w in wavs) and any("hyp" in str(w) for w in wavs)
        for split in ("subtrain", "val"):
            blob = json.loads((Path(cfg.log_dir) / "2" / split / "metrics.json").read_text())
            assert blob["mean"]["n_utts"] >= 1 and blob["mean"]["name"] == split
            assert 0.0 <= blob["mean"]["acc"] <= 1.0 and blob["mean"]["mcd"] >= 0.0
            assert len(blob["per_utt"]) == blob["mean"]["n_utts"]
    elif name == "profile_every":
        traces = list((Path(cfg.log_dir) / "profile").iterdir())
        assert [t.name for t in traces] == ["step_2"]
        events = json.loads((traces[0] / "trace.json").read_text())["traceEvents"]
        assert any(e.get("name") == "ProfilerStep" or e.get("ph") == "X" for e in events)
    elif name == "cache_dataloader":
        assert len(list((tmp_path / ".cache" / "tiny").glob("datasets-*.json"))) == 1
    else:
        assert engines["model"].module.denoiser.remat_context is not torch.utils.checkpoint.noop_context_fn


def test_stdin_commands_read_one_line_per_poll_and_stop_at_end_of_stream():
    r, w = os.pipe()
    with os.fdopen(r) as stream:
        cmds = StdinCommands(stream)
        assert cmds.poll() == ""  # nothing written yet: no block
        with os.fdopen(w, "w") as writer:
            writer.write("save\n\nquit\n")
        assert [cmds.poll() for _ in range(3)] == ["save", "", "quit"]
        assert cmds.poll() == "" and cmds.selector is None  # end of stream: dropped
        assert cmds.poll() == ""


def test_async_stats_come_one_step_late_and_flush(tmp_path):
    pm = DiffusionModel(DiffusionConfig(**KW), dtype=torch.float32)
    rs = np.random.RandomState(0)

    def loss_fn(module, batch, generator):
        return module.loss(batch, generator, q_noise=t(rs.rand(2, 12, 33).astype(np.float32)))

    engines = Engines(model=Engine("model", pm, loss_fn, _opt_cfg(1), tmp_path))
    engines.setup(Config(async_stats=True, device="cpu"))
    first = engines.step(_batch(0))
    assert "model.loss" not in first and first["global_step"] == 1
    second = engines.step(_batch(1))
    assert second["global_step"] == 1 and np.isfinite(second["model.loss"])
    last = engines.flush_stats()
    assert last["global_step"] == 2 and engines.flush_stats() is None
