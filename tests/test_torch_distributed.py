"""The port's process bootstrap, mesh rules, collectives, dp=2 / tp=2
training, ZeRO-1, the loaders' bucket agreement, sharded generation and
tensor-parallel serving, on the CPU: real processes in a ``gloo`` group of
2 on 127.0.0.1, launched once for the module with torchrun's environment
(``world2``: ``run_world2`` runs every scenario and writes what the tests
read), and the serve CLI under ``python -m torch.distributed.run``.

Tolerances (fp32): dp=2 and tp=2 runs against the port's 1×1 runs after 3
steps within 1e-5·max(1, |ref|) per parameter, with parameters bit-identical
across a dp group after every step; ZeRO-1's trajectory against the
replicated engine's within 1e-5; collectives bit for bit against the values
each rank computes alone; codes identical;
the first denoiser call under tp=2 against JAX's single-device logits within
1e-4·max(1, |ref|).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_parallel as P  # noqa: E402

from tts_with_diffusion_model_tpu_torch.parallel import comm  # noqa: E402
from tts_with_diffusion_model_tpu_torch.parallel.mesh import (  # noqa: E402
    Split, build_mesh, param_shardings, shard_batch, zero1_shardings)
from tts_with_diffusion_model_tpu_torch.utils import distributed  # noqa: E402

SERVE_DIMS = dict(d_model=32, n_heads=4, n_layers=2)
SERVE_D3PM = dict(timesteps=20, resp_len=64, text_len=50, prom_len=64, gen_len=40)
CODEC_DIMS = dict(dimension=16, n_filters=4, n_q_total=8)
TEXTS = ("she said hello", "make some noise")


# ---------------- the scenarios ----------------

def write_serve_files(root: Path) -> None:
    """A tiny seeded D3PM and NAR bundle (written by the port) and a tiny
    seeded codec."""
    from tts_with_diffusion_model_tpu_torch import smoke
    from tts_with_diffusion_model_tpu_torch.convert import init_seeded
    from tts_with_diffusion_model_tpu_torch.export import bundle_params, save_bundle
    from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig, DiffusionModel
    from tts_with_diffusion_model_tpu_torch.models.nar import NAR
    from tts_with_diffusion_model_tpu_torch.smoke_codec import write_seeded_codec

    symmap = smoke.default_symmap()
    d3pm = DiffusionModel(DiffusionConfig(n_classes=1025, **SERVE_D3PM, **SERVE_DIMS))
    init_seeded(d3pm.denoiser, 5)
    save_bundle(root / "diffusion", bundle_params(d3pm),
                dict(model="diffusion", num_tokens=1024, **SERVE_D3PM, **SERVE_DIMS), symmap,
                {"spk": 0})
    nar = NAR(1024, remat=False, **SERVE_DIMS)
    init_seeded(nar, 6)
    save_bundle(root / "nar", bundle_params(nar), dict(model="nar", num_tokens=1024, **SERVE_DIMS),
                symmap, {"spk": 0})
    write_seeded_codec(root / "codec.npz", 0, CODEC_DIMS)


def serve_codes(root: Path, mesh_tp: int):
    """The codes of two requests in one device batch (fp32, MaskGIT 4 steps)
    from a ``Synthesizer(mesh_tp=...)``; rank 0 returns them, a follower
    runs ``follow`` and returns None."""
    from tts_with_diffusion_model_tpu_torch.serve import Synthesizer, load_model

    first, symmap = load_model(root / "diffusion", torch.float32)
    nar, _ = load_model(root / "nar", torch.float32)
    synth = Synthesizer(first, nar, None, symmap, device="cpu", bf16=False, max_batch=2,
                        maskgit_steps=4, mesh_tp=mesh_tp)
    if synth.is_follower:
        synth.follow()
        return None
    rs = np.random.RandomState(3)
    rows = [synth._prepare_ids(synth.phone_ids(t), rs.randint(0, 1024, (30 + 20 * i, 8)))
            for i, t in enumerate(TEXTS)]
    codes = synth.synthesize_codes_batch(rows, [5, 6])
    synth.stop_followers()
    return np.stack(codes)


def loader_cfg(corpus: Path, native: bool, **kw):
    from tts_with_diffusion_model_tpu_torch.config import Config

    kw = {"nj": 1, **kw}
    return Config(data_dirs=[corpus], spkr_name_getter="parts:-2", min_phones=3, batch_size=4,
                  eval_batch_size=4, max_num_val=6, use_native_loader=native,
                  resp_len_buckets=[16, 24, 32], prom_len_buckets=[64], bucket_window_batches=2,
                  max_prompts=3, seed=5, **kw)


def rank_block(rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of the collectives' check: integer-valued
    floats, so that any summation order is exact."""
    return torch.arange(24, dtype=torch.float32).reshape(4, 6) * (rank + 1) - 7


class _Rows:
    """A base loader whose rows' valid response lengths are uniform in
    [lo, hi]."""

    kind = "python"

    def __init__(self, lo: int, hi: int, seed: int):
        self.lo, self.hi, self.rs = lo, hi, np.random.RandomState(seed)

    def __iter__(self):
        while True:
            n = self.rs.randint(self.lo, self.hi + 1, 2)
            mask = (np.arange(48)[None] < n[:, None]).astype(np.float32)
            yield {"resps": np.zeros((2, 48, 8), np.int32), "resp": np.zeros((2, 48), np.int32),
                   "resp_mask": mask, "proms": np.zeros((2, 96, 8), np.int32),
                   "prom_mask": np.ones((2, 96), np.float32)}


def run_world2(out: Path) -> None:
    from tts_with_diffusion_model_tpu_torch.data.dataset import (BucketSpec, LengthBucketedLoader,
                                                                 _process_offset,
                                                                 create_train_val_dataloader)
    from tts_with_diffusion_model_tpu_torch.parallel.infer import (make_sharded_generate,
                                                                   shard_params)

    rank = distributed.global_rank()
    lead = rank == 0
    rec: dict = {"rank": rank}
    # bootstrap
    rec["boot"] = dict(
        init=distributed.init_distributed("cpu"), world=distributed.world_size(),
        rank=distributed.global_rank(), local=distributed.local_rank(),
        leaders=[distributed.is_global_leader(), distributed.is_local_leader()],
        decorated=[distributed.global_leader_only(lambda: "ran", default="skipped")(),
                   distributed.local_leader_only(default=-1)(lambda: rank)()],
        broadcast=distributed.broadcast_object({"cmd": "save@100", "step": 7} if lead else None),
        max_int=distributed.all_reduce_max_int(3 + 5 * rank), offset=_process_offset())
    distributed.barrier()
    # collectives: against the values each rank computes alone
    axis = build_mesh(2, 1).dp
    blocks = [rank_block(r) for r in range(2)]
    rec["collectives"] = {}
    for d in (0, 1):
        n = blocks[0].shape[d] // 2
        rec["collectives"][f"all_gather dim {d}"] = torch.equal(
            comm.all_gather(blocks[rank], axis, d), torch.cat(blocks, d))
        rec["collectives"][f"reduce_scatter dim {d}"] = torch.equal(
            comm.reduce_scatter(blocks[rank], axis, d),
            (blocks[0] + blocks[1]).narrow(d, rank * n, n))
    # dp=2 and tp=2 training, and ZeRO-1 at dp=2
    meshes = {"dp2": build_mesh(2, 1), "tp2": build_mesh(1, 2)}
    for name, mesh in meshes.items():
        for family in P.FAMILIES:
            engine, losses, digests = P.train_run(family, mesh, out / f"ck_{name}_{family}")
            rec[f"{name} {family}"] = {"losses": losses, "digests": digests}
            full = engine.full_state_dict()
            if lead:
                P.save_tensors(out / f"{name}_{family}.npz", full)
    engine, losses, digests = P.train_run("nar", meshes["dp2"], out / "ck_acc", steps=4, accum=2)
    rec["accum"] = {"losses": losses, "digests": digests}
    full = engine.full_state_dict()
    if lead:
        P.save_tensors(out / "accum.npz", full)
    engine, losses, digests = P.train_run("d3pm", meshes["dp2"], out / "ck_z1", zero1=True)
    rec["zero1"] = {"losses": losses, "digests": digests, "moment_bytes": sum(
        v.numel() * v.element_size() for st in engine.optimizer.state.values()
        for k, v in st.items() if k != "step")}
    full = engine.full_state_dict()
    if lead:
        P.save_tensors(out / "zero1.npz", full)
    # a ZeRO-1 checkpoint written before the first update, restored into an
    # engine seeded otherwise: its blocks must come from the restored weights
    saved = P.Engine("model", P.build("d3pm"), P.loss_fn("d3pm"), P.opt_cfg(), out / "ck_z1_0",
                     mesh=meshes["dp2"], zero1=True)
    saved.save_checkpoint()
    restored = P.Engine("model", P.build("d3pm", seed=2), P.loss_fn("d3pm"), P.opt_cfg(),
                        out / "ck_z1_0", mesh=meshes["dp2"], zero1=True)
    restored.load_checkpoint()
    rec["zero1 step 0"] = [P.train_run("d3pm", meshes["dp2"], None, steps=1, engine=e)[2]
                           for e in (saved, restored)]
    # sharded generation, the ragged batch, the first denoiser call under tp
    for name, mesh in meshes.items():
        for sampler, codes in P.sample_all(mesh).items():
            rec[f"codes {name} {sampler}"] = codes.tolist()
    gen = make_sharded_generate(P.build("d3pm", seed=3), meshes["dp2"])
    try:
        gen(*P.gen_inputs(3), P.SEEDS[:3])
        rec["ragged"] = "no error"
    except ValueError as e:
        rec["ragged"] = str(e)
    model = shard_params(meshes["tp2"], P.build("d3pm", seed=3))
    with torch.no_grad():
        logits = model.denoiser(*first_call_inputs())
    if lead:
        np.save(out / "tp2_logits.npy", logits.numpy())
    # the loaders' buckets: each rank its own stream, one bucket per batch
    bucket = BucketSpec(16, 96, 48)
    for native in (False, True):
        dl = create_train_val_dataloader(loader_cfg(out / "corpus", native), bucket,
                                         meshes["dp2"])[0]
        it = iter(dl)
        shapes = [(b["resp_mask"].shape, b["prom_mask"].shape) for b, _ in zip(it, range(6))]
        rec[f"loader {'native' if native else 'python'}"] = {
            "shapes": shapes, "kind": dl.kind,
            "rows": [[str(p) for p in b["path"]] for b, _ in zip(it, range(2))]}
        dl.close()
        # tp=2 at the default nj: one batch per tp row
        dl = create_train_val_dataloader(loader_cfg(out / "corpus", native, nj=8), bucket,
                                         meshes["tp2"])[0]
        rec[f"loader tp2 {'native' if native else 'python'}"] = {
            "kind": dl.kind, "rows": [[str(p) for p in b["path"]] + [b["resp_mask"].shape]
                                      for b, _ in zip(dl, range(6))]}
        dl.close()
    # rank 0's rows alone would take the 16 bucket, rank 1's need 32
    short = LengthBucketedLoader(_Rows(1, 10, 0) if lead else _Rows(25, 30, 1), bucket,
                                 [16, 24, 32], window=2)
    rec["loader short rank"] = [b["resp_mask"].shape[1] for b, _ in zip(short, range(6))]
    # tensor-parallel serving
    codes = serve_codes(out / "serve", 2)
    if lead:
        np.save(out / "serve_codes.npy", codes)
    (out / f"rank{rank}.json").write_text(json.dumps(rec))


def first_call_inputs():
    text, tm, proms, pm = P.gen_inputs()
    resp = torch.as_tensor(np.random.RandomState(9).randint(0, 65, (P.B, P.DIT["resp_len"])))
    rm = torch.ones(P.B, P.DIT["resp_len"])
    rm[0, 7:] = 0
    return text, tm, proms, pm, resp, rm, torch.tensor([5, 3, 1, 2])


# ---------------- the tests ----------------

@pytest.fixture(scope="module")
def world2_ranks(tmp_path_factory):
    """The world-2 ranks, started when the module's first test asks."""
    from tts_with_diffusion_model_tpu_torch import smoke_train
    from tts_with_diffusion_model_tpu_torch.data import native_loader

    out = tmp_path_factory.mktemp("world2")
    smoke_train.write_train_corpus(out / "corpus", n_speakers=3, n_utts=12, seed=0,
                                   frames=(10, 40), phones=(3, 12))
    write_serve_files(out / "serve")
    native_loader.load_library()  # one build, before the ranks use it
    launched = P.Launch("world2", 2, out)
    yield launched
    try:
        launched.wait()
    except RuntimeError:
        pass


@pytest.fixture
def world2(world2_ranks):
    out = world2_ranks.wait()
    return out, [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]


def test_tp2_first_denoiser_call_matches_jax_single_device(world2_ranks):
    """JAX computes its logits while the ranks run."""
    import jax.numpy as jnp

    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionConfig as JCfg
    from tts_with_diffusion_model_tpu.models.diffusion import DiffusionModel as JModel
    from tts_with_diffusion_model_tpu_torch.convert import torch_params_to_jax

    from torch_port_helpers import unflatten

    port = P.build("d3pm", seed=3)
    flat = {f"params/{k}": v for k, v in torch_params_to_jax(port.denoiser).items()}
    jm = JModel(JCfg(**P.DIT, **P.TINY), dtype=jnp.float32)
    ref = np.asarray(jm.denoiser.apply(unflatten(flat), *[
        jnp.asarray(a.numpy().astype(np.int32) if not a.is_floating_point() else a.numpy())
        for a in first_call_inputs()]))
    got = np.load(world2_ranks.wait() / "tp2_logits.npy")
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, float(np.abs(ref).max()))


def test_two_process_bootstrap(world2):
    _, ranks = world2
    for r, rec in enumerate(ranks):
        b = rec["boot"]
        assert b["init"] is True and b["world"] == 2 and b["rank"] == r and b["local"] == r
        assert b["leaders"] == [r == 0, r == 0]
        assert b["decorated"] == (["ran", 0] if r == 0 else ["skipped", -1])
        assert b["broadcast"] == {"cmd": "save@100", "step": 7}
        assert b["max_int"] == 8 and b["offset"] == r


def test_world_of_one_degenerates():
    assert distributed.init_distributed("cpu") is False
    assert (distributed.world_size(), distributed.global_rank(), distributed.local_rank()) == (
        1, 0, 0)
    assert distributed.is_global_leader() and distributed.is_local_leader()
    assert distributed.global_leader_only(lambda: 1)() == 1
    assert distributed.broadcast_object({"a": 1}) == {"a": 1}
    assert distributed.all_reduce_max_int(5) == 5
    distributed.barrier()
    axis = build_mesh().dp
    x = torch.ones(2, 3)
    assert comm.all_gather(x, axis) is x and comm.reduce_scatter(x, axis) is x


def test_build_mesh_rules_and_errors():
    mesh = build_mesh(-1, 1)
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.size == 1 and mesh.coords == (0, 0)
    with pytest.raises(AssertionError, match="not divisible by tp=2"):
        build_mesh(-1, 2)
    with pytest.raises(AssertionError, match="mesh dp=2 x tp=1 needs 2 devices"):
        build_mesh(2, 1)


def test_ragged_vocab_replicates_and_heads_split():
    """A 1025-way vocabulary (the D3PM's) does not divide tp=2 and
    replicates; the NAR's 1024-way tables and every heads / mlp dimension
    split."""
    from tts_with_diffusion_model_tpu_torch.models.diffusion import DiffusionConfig, DiffusionModel
    from tts_with_diffusion_model_tpu_torch.models.nar import NAR

    d3pm = param_shardings(2, DiffusionModel(DiffusionConfig(d_model=32, n_heads=4, n_layers=1)))
    for k in ("denoiser.text_emb.weight", "denoiser.resps_emb.weight",
              "denoiser.proms_emb.weight", "denoiser.final.weight", "denoiser.time_emb.weight",
              "denoiser.dit_0.timestep_fc.weight"):
        assert d3pm[k] is None, k
    assert d3pm["denoiser.dit_0.attn.q.weight"] == Split(0, "heads")
    assert d3pm["denoiser.dit_0.attn.out.weight"] == Split(1, "heads")
    assert d3pm["denoiser.dit_0.mlp.fc1.bias"] == Split(0, "mlp")
    assert d3pm["denoiser.text_tower.mlp.fc2.weight"] == Split(1, "mlp")
    nar = param_shardings(2, NAR(1024, d_model=32, n_heads=4, n_layers=1))
    assert nar["base.classifier.weight"] == Split(0, "vocab")
    assert nar["base.proms_emb.weight"] == Split(1, "vocab")
    assert nar["base.block_0.attn.to_qkv.weight"] == Split(0, "heads", 3)
    assert nar["base.block_0.norm_attn.emb"] is None
    ar = param_shardings(2, P.build("ar"))
    assert ar["base.classifier.weight"] is None and ar["base.text_emb.weight"] is not None
    # 3 heads over tp=2: the attention replicates
    assert param_shardings(2, NAR(64, d_model=24, n_heads=3, n_layers=1))[
        "base.block_0.attn.to_qkv.weight"] is None


def test_packed_qkv_gives_each_rank_its_heads_of_q_k_and_v():
    from tts_with_diffusion_model_tpu_torch.parallel.mesh import shard_tensor, unshard_tensor

    H, Dh, d, tp = 4, 2, 3, 2
    full = torch.arange(3 * H * Dh * d, dtype=torch.float32).reshape(3 * H * Dh, d)
    split = Split(0, "heads", 3)
    blocks = [shard_tensor(full, split, r, tp) for r in range(tp)]
    for r, blk in enumerate(blocks):
        want = full.view(3, H, Dh, d)[:, r * 2:(r + 1) * 2].reshape(-1, d)
        assert torch.equal(blk, want)
    assert torch.equal(unshard_tensor(torch.cat(blocks), split, tp), full)


def test_zero1_layout_never_undoes_a_tp_split():
    from tts_with_diffusion_model_tpu_torch.parallel.mesh import Mesh

    model = P.build("nar")
    layout = param_shardings(2, model)
    mesh = Mesh(comm.Axis(None, 4, 0), comm.Axis(None, 2, 0))
    model._tp_layout = layout  # what shard_module records
    z = zero1_shardings(mesh, model)
    assert sum(d is not None for d in z.values()) > 0
    for name, d in z.items():
        split = layout[name]
        if split is not None:
            assert d != split.dim, name


def test_shard_batch_takes_the_rows_and_refuses_a_ragged_batch():
    from tts_with_diffusion_model_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(comm.Axis(None, 2, 1), comm.Axis(None, 1, 0))
    got = shard_batch({"x": np.arange(8).reshape(4, 2), "path": ["a", "b"]}, mesh)
    assert got["x"].tolist() == [[4, 5], [6, 7]] and got["path"] == ["a", "b"]
    with pytest.raises(ValueError, match="not divisible by the dp mesh axis"):
        shard_batch({"x": np.zeros((3, 2))}, mesh)


def test_collectives_equal_what_each_rank_computes_alone(world2):
    _, ranks = world2
    for rec in ranks:
        assert rec["collectives"] and all(rec["collectives"].values()), rec["collectives"]


@pytest.mark.parametrize("family", P.FAMILIES)
@pytest.mark.parametrize("mesh", ["dp2", "tp2"])
def test_dp2_and_tp2_training_equal_1x1(world2, family, mesh):
    out, ranks = world2
    ref_losses, ref = one_by_one_runs(family)
    np.testing.assert_allclose(ranks[0][f"{mesh} {family}"]["losses"], ref_losses, rtol=1e-5)
    P.assert_params_close(dict(np.load(out / f"{mesh}_{family}.npz")), ref)
    if mesh == "dp2":  # the dp group: bit-identical after every step
        assert ranks[0][f"{mesh} {family}"]["digests"] == ranks[1][f"{mesh} {family}"]["digests"]


_ONE_BY_ONE: dict = {}


def one_by_one_runs(family: str):
    if family not in _ONE_BY_ONE:
        engine, losses, _ = P.train_run(family, build_mesh(1, 1), Path("unused"))
        _ONE_BY_ONE[family] = (losses, {k: v.numpy().copy()
                                        for k, v in engine.full_state_dict().items()})
    return _ONE_BY_ONE[family]


def test_gradient_accumulation_under_dp2(world2):
    """Two micro-batches per update at dp=2 follow the 1×1 run's (NAR,
    dropout on, 4 micro-batches)."""
    out, ranks = world2
    engine, losses, _ = P.train_run("nar", build_mesh(1, 1), Path("unused"), steps=4, accum=2)
    np.testing.assert_allclose(ranks[0]["accum"]["losses"], losses, rtol=1e-5)
    P.assert_params_close(dict(np.load(out / "accum.npz")),
                          {k: v.numpy() for k, v in engine.full_state_dict().items()})
    assert ranks[0]["accum"]["digests"] == ranks[1]["accum"]["digests"]
    assert engine.update_count == 2


def test_zero1_trajectory_and_moment_bytes(world2):
    """ZeRO-1 at dp=2 follows the replicated engine's trajectory (1e-5) and
    keeps at most half of Adam's moments (plus one leaf's) on each rank."""
    out, ranks = world2
    ref_losses, ref = one_by_one_runs("d3pm")
    np.testing.assert_allclose(ranks[0]["zero1"]["losses"], ranks[0]["dp2 d3pm"]["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["zero1"]["losses"], ref_losses, rtol=1e-5)
    P.assert_params_close(dict(np.load(out / "zero1.npz")), ref)
    assert ranks[0]["zero1"]["digests"] == ranks[1]["zero1"]["digests"]
    sizes = [2 * p.numel() * 4 for p in P.build("d3pm").parameters()]  # two fp32 moments
    for rec in ranks:
        assert rec["zero1"]["moment_bytes"] <= sum(sizes) / 2 + max(sizes)
        assert rec["zero1"]["moment_bytes"] < sum(sizes)


@pytest.mark.parametrize("sampler", list(P.SAMPLERS))
@pytest.mark.parametrize("mesh", ["dp2", "tp2"])
def test_sharded_generate_codes_equal_one_process(world2, mesh, sampler):
    _, ranks = world2
    single = P.sample_all(build_mesh(1, 1)) if "single" not in _ONE_BY_ONE else _ONE_BY_ONE[
        "single"]
    _ONE_BY_ONE["single"] = single
    for rec in ranks:
        np.testing.assert_array_equal(np.asarray(rec[f"codes {mesh} {sampler}"]), single[sampler])


def test_sharded_generate_refuses_a_ragged_batch(world2):
    _, ranks = world2
    assert "batch 3 does not divide the dp mesh axis (2)" in ranks[0]["ragged"]


@pytest.mark.parametrize("loader", ["python", "native"])
def test_loader_buckets_agree_across_ranks(world2, loader):
    _, ranks = world2
    a, b = (rec[f"loader {loader}"] for rec in ranks)
    assert a["kind"] == b["kind"] == loader
    assert a["shapes"] == b["shapes"] and len(a["shapes"]) == 6
    assert all(s[0][0] == 2 for s in a["shapes"])  # batch_size 4 over dp 2
    assert a["rows"] != b["rows"]  # each rank its own stream


@pytest.mark.parametrize("loader", ["python", "native"])
def test_loader_gives_a_tp_row_one_batch(world2, loader):
    """At tp=2 with the default nj (several loader threads or C++ workers),
    both ranks of the tp row get the same rows, in the same order."""
    _, ranks = world2
    a, b = (rec[f"loader tp2 {loader}"] for rec in ranks)
    assert a["kind"] == b["kind"] == loader
    assert a["rows"] == b["rows"] and len(a["rows"]) == 6
    assert all(len(r) == 4 + 1 for r in a["rows"])  # the whole batch of 4 on each rank


def test_zero1_restore_of_a_step_0_checkpoint(world2):
    """A ZeRO-1 engine restored from a checkpoint saved before its first
    update takes the next step as the engine that saved it."""
    _, ranks = world2
    for rec in ranks:
        saved, restored = rec["zero1 step 0"]
        assert saved == restored


def test_restore_of_a_positional_optimizer_state(tmp_path):
    """A checkpoint whose optimizer state is ``optimizer.state_dict()`` (keyed
    by position, as 1×1 engines wrote it before it was keyed by name)
    restores Adam's moments, and the next step is the saving engine's."""
    a, _, _ = P.train_run("nar", build_mesh(1, 1), tmp_path, steps=2)
    state = a._state()
    state["optimizer"] = a.optimizer.state_dict()
    (tmp_path / "model").mkdir()
    torch.save(state, tmp_path / "model" / "step_00000002.pt")
    b = P.Engine("model", P.build("nar", seed=2), P.loss_fn("nar"), P.opt_cfg(), tmp_path,
                 ema_decay=0.9)
    assert b.load_checkpoint() and b.step == 2
    for p, q in zip(a.opt_params, b.opt_params):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k])
    assert (P.train_run("nar", build_mesh(1, 1), None, steps=1, engine=a)[2]
            == P.train_run("nar", build_mesh(1, 1), None, steps=1, engine=b)[2])


def test_loader_buckets_agree_when_one_rank_is_all_short(world2):
    _, ranks = world2
    assert ranks[0]["loader short rank"] == ranks[1]["loader short rank"]
    assert all(r == 32 for r in ranks[0]["loader short rank"])


def test_tp2_synthesizer_codes_equal_mesh_tp_1(world2):
    out, _ = world2
    np.testing.assert_array_equal(np.load(out / "serve_codes.npy"),
                                  serve_codes(out / "serve", 1))


def test_synthesizer_mesh_tp_without_a_group_raises(world2):
    out, _ = world2
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        serve_codes(out / "serve", 2)


def _post(port: int, body: dict):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/tts", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_serve_cli_under_torchrun_with_mesh_tp_2(world2):
    """``torch.distributed.run --nproc-per-node 2 -m ...serve --mesh-tp 2``:
    rank 0 answers 3 /tts requests (its follower runs each device batch),
    SIGTERM to rank 0 drains and stops the follower, and both ranks and the
    launcher exit 0 with no abort in the launcher's stderr."""
    from tts_with_diffusion_model_tpu_torch import smoke

    out, _ = world2
    root = out / "serve"
    ref = smoke.reference_wavs(1, 0.3, seed=52)[0]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(P.REPO))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(P.free_port()),
         "-m", "tts_with_diffusion_model_tpu_torch.serve", "--device", "cpu",
         "--ar-ckpt", str(root / "diffusion"), "--nar-ckpt", str(root / "nar"),
         "--codec", str(root / "codec.npz"), "--port", "0", "--max-batch", "2",
         "--maskgit-steps", "2", "--mesh-tp", "2"],
        cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    log = []
    try:
        port = pid = None
        timer = threading.Timer(P.CHILD_TIMEOUT_S, lambda: os.killpg(proc.pid, signal.SIGKILL))
        timer.start()
        for line in proc.stderr:
            log.append(line)
            if "Serving on http://" in line:
                port = int(line.split("http://", 1)[1].split(" ")[0].rsplit(":", 1)[1])
                pid = int(line.rsplit("pid ", 1)[1].split(")")[0])
                break
        assert port, "".join(log)
        for i, text in enumerate(("she said hello", "make some noise", "a third one")):
            status, body = _post(port, {"text": text, "reference": str(ref), "seed": i})
            assert status == 200 and body[:4] == b"RIFF"
        os.kill(pid, signal.SIGTERM)
        log += proc.stderr.readlines()
        assert proc.wait(timeout=P.CHILD_TIMEOUT_S) == 0, "".join(log)
        timer.cancel()
        assert any("follower rank 1: " in line for line in log), "".join(log)
        assert not any("terminate called" in line for line in log), "".join(log)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        proc.stderr.close()


#: the modules torchrun launches, and the package their ``__main__`` block
#: imports from
TORCHRUN_ENTRY_POINTS = ["serve", "train.train", "train.__main__", "export", "codec.train"]


def _main_block(module: str):
    """The ``if __name__ == "__main__":`` block of a port module, compiled
    on its own, and the package its relative imports resolve in."""
    import ast

    name = f"tts_with_diffusion_model_tpu_torch.{module}"
    path = P.REPO / (name.replace(".", "/") + ".py")
    tree = ast.parse(path.read_text())
    block = next(node for node in tree.body if isinstance(node, ast.If)
                 and ast.unparse(node.test) in ("__name__ == '__main__'", '__name__ == "__main__"'))
    return compile(ast.Module(body=block.body, type_ignores=[]), str(path), "exec"), \
        name.rsplit(".", 1)[0]


@pytest.mark.parametrize("fails", [False, True], ids=["returns", "raises"])
@pytest.mark.parametrize("module", TORCHRUN_ENTRY_POINTS)
def test_entry_point_tears_its_process_group_down(module, fails, tmp_path):
    """Each entry point's ``__main__`` block, its ``main`` standing in for a
    rank that joins a gloo group (a world of one over a file store) and then
    returns or raises, leaves no process group up
    (``distributed.shutdown_distributed``): a group left up at exit is
    destroyed in the interpreter's teardown, which aborted a torchrun rank
    now and then after its work was done ("terminate called without an
    active exception")."""
    import torch.distributed as dist

    code, package = _main_block(module)

    def main():
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                world_size=1, rank=0)
        if fails:
            raise RuntimeError("the entry point failed")

    assert not dist.is_initialized()
    try:
        with pytest.raises(RuntimeError) if fails else contextlib.nullcontext():
            exec(code, {"__name__": "__main__", "__package__": package, "main": main})
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
