"""The chip phase "parallel": the port's dp×tp mesh driven on one card.

    python -m tts_with_diffusion_model_tpu_torch.smoke_parallel [--seed 0]
    python -m tts_with_diffusion_model_tpu_torch.smoke_parallel --tiny --device cpu

One card holds one NCCL rank, so the phase runs (each rank a process with
torchrun's environment, ``utils/distributed.init_distributed``):

  - NCCL, a world of one: ``config/gen4c/diffusion.yml``'s D3PM 4 steps with
    ``zero1`` at 1×1 and a MaskGIT batch of 4 through
    ``make_sharded_generate``, first with no process group, then in an NCCL
    group: parameters and codes bit-identical, step p50 of both;
  - gloo, 2 ranks sharing the card (NCCL refuses two ranks on one device):
    (a) dp=2, 4 D3PM steps at B=32 (16 per rank), then again with ``zero1``
    (each rank's moment bytes); (b) tp=2, 4 ``config/gen4c/nar.yml`` steps
    (8 heads per rank); (c) ``Synthesizer(mesh_tp=2)`` over the main path
    (DiT → NAR → EnCodec), 4 requests; (d) a MaskGIT batch of 4 through
    ``make_sharded_generate`` at dp=2.  Everything in fp32 with TF32 off,
    held against one process's run of the same work: parameters within
    1e-5·max(1, |ref|) (the DiT's attention key biases, whose gradient is
    rounding noise, within 2·lr·steps), identical across the dp group after
    every step, codes identical;
  - (e) both kernels against their plain versions at every per-rank shape
    the ranks recorded.

Every kernel launch a rank makes is counted from 0 around its path, and the
counts are checked against the paths' sites.  A gloo time is two ranks
sharing one card through host-staged collectives, not a multi-card time.
``--tiny --device cpu`` rehearses it all at narrow widths on the CPU (the
plain versions, no times).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from .ops import masked_attention as serve_ops
from .ops import train_flash_attention as train_ops
from .smoke import SMOKE_DIR, SmokeError, check, log

D3PM_YAML = Path(__file__).resolve().parents[1] / "config" / "gen4c" / "diffusion.yml"
NAR_YAML = D3PM_YAML.with_name("nar.yml")
GLOO_LABEL = ("two ranks sharing one card through gloo (host-staged collectives), "
              "not a multi-card time")
STEPS = 4
PARAM_TOL = 1e-5
RANK_TIMEOUT_S = 600
TINY_MODEL = "{d_model: 32, n_heads: 4, n_layers: 2}"
#: global batch sizes: (a) the D3PM at the recipe's 32; (b) the NAR at 4
#: (its tp activations cross the host twice per block each way)
SIZES = {"full": {"d3pm": 32, "nar": 4, "serve": 4},
         "tiny": {"d3pm": 4, "nar": 2, "serve": 2}}


# ---------------- the work (one process or a rank) ----------------

def recipe(yaml: Path, device, tiny: bool, *extra):
    """A recipe's config (fp32 compute, paths under ``build/smoke``) and its
    seeded model on ``device``."""
    from .config import Config
    from .train.train import build_model, init_params

    out = SMOKE_DIR / "parallel"
    argv = [f"yaml={yaml}", f"device={device}", "use_fp16=false", "async_stats=false",
            f"log_root={out / 'logs'}", *extra]
    if tiny:
        argv.append(f"model_overrides={TINY_MODEL}")
    cfg = Config.from_cli(argv)
    model = build_model(cfg, device)
    init_params(cfg, model)
    return cfg, model


def buckets(cfg, model) -> tuple[int, int, int]:
    """(text, prompt, response) slots of a training batch: the D3PM's config
    and its smallest response bucket; the NAR's largest length buckets."""
    c = getattr(model, "config", None)
    if c is not None:
        return c.text_len, c.prom_len, min(cfg.resp_len_buckets)
    return cfg.max_text_len, max(cfg.prom_len_buckets), max(cfg.resp_len_buckets)


def global_batch(cfg, model, B: int, step: int, seed: int) -> dict:
    """A seeded global batch at the training buckets, each row's valid
    lengths drawn in [half, all] of each bucket (so dp ranks hold unequal
    token counts)."""
    rs = np.random.RandomState(seed * 1000 + step)
    Tt, Tp, Tr = buckets(cfg, model)
    out = {}
    for key, T in (("text_mask", Tt), ("prom_mask", Tp), ("resp_mask", Tr)):
        n = rs.randint(T // 2, T + 1, B)
        out[key] = (np.arange(T)[None] < n[:, None]).astype(np.float32)
    out["text"] = (rs.randint(1, 100, (B, Tt)) * out["text_mask"]).astype(np.int64)
    out["proms"] = rs.randint(0, 1024, (B, Tp, 8)).astype(np.int64)
    out["resps"] = (rs.randint(0, 1024, (B, Tr, 8)) * out["resp_mask"][..., None]).astype(np.int64)
    out["resp"] = out["resps"][..., 0].copy()
    return out


def digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def zero_counts():
    k1, k2 = serve_ops.masked_attention, train_ops.train_flash_attention
    k1.launches = k1.plain_calls = k2.launches = k2.backward_launches = k2.plain_calls = 0
    k1.shapes, k2.shapes = Counter(), Counter()


def read_counts(device) -> dict:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    k1, k2 = serve_ops.masked_attention, train_ops.train_flash_attention
    out = {"kernel1": k1.launches, "kernel2_fwd": k2.launches, "kernel2_bwd": k2.backward_launches,
           "plain": k1.plain_calls + k2.plain_calls,
           "shapes1": [[list(s), n] for s, n in k1.shapes.items()],
           "shapes2": [[list(s), n] for s, n in k2.shapes.items()]}
    k1.shapes = k2.shapes = None
    return out


def train_steps(yaml: Path, mesh, device, tiny: bool, B: int, seed: int, zero1: bool = False,
                save: Path | None = None) -> dict:
    """``STEPS`` engine steps of a recipe on the mesh, this rank's dp rows
    of each global batch, the step generator seeded alike on every rank →
    the losses, the step times (host clock around a synchronised step),
    this rank's parameter digest and kernel-2 launches after each step, and
    its Adam moment bytes; the full parameters go to ``save`` (global
    leader)."""
    from .parallel.mesh import shard_batch
    from .train.train import load_engines
    from .utils import distributed

    root = SMOKE_DIR / "parallel" / f"ckpt_{os.getpid()}"
    shutil.rmtree(root, ignore_errors=True)
    cfg, model = recipe(yaml, device, tiny, f"ckpt_root={root}", f"zero1={zero1}", f"seed={seed}")
    engines = load_engines(cfg, model, mesh)
    engine = engines["model"]
    fn = train_ops.train_flash_attention
    rec = {"losses": [], "step_s": [], "digests": [], "launches": []}
    for step in range(STEPS):
        batch = shard_batch(global_batch(cfg, model, B, step, seed), mesh)
        before = (fn.launches, fn.backward_launches)
        stats = engines.step(batch)
        rec["losses"].append(stats["model.loss"])
        rec["step_s"].append(stats["elapsed_time"])
        rec["launches"].append([fn.launches - before[0], fn.backward_launches - before[1]])
        rec["digests"].append(digest(engine.params))
    rec["moment_bytes"] = sum(v.numel() * v.element_size() for st in engine.optimizer.state.values()
                              for k, v in st.items() if k != "step")
    full = engine.full_state_dict()
    if save is not None and distributed.is_global_leader():
        torch.save({k: v.cpu() for k, v in full.items()}, save)
    shutil.rmtree(root, ignore_errors=True)
    return rec


def maskgit_codes(mesh, device, tiny: bool, B: int, seed: int) -> np.ndarray:
    """A MaskGIT batch of ``B`` (12 steps, the serving bucket) through
    ``make_sharded_generate`` on the mesh, from the recipe's seeded D3PM."""
    from .parallel.infer import make_sharded_generate, shard_params

    _, model = recipe(D3PM_YAML, device, tiny, f"seed={seed}")
    model = shard_params(mesh, model.eval())
    c = model.config
    rs = np.random.RandomState(seed + 77)
    text = torch.as_tensor(rs.randint(1, 100, (B, c.text_len)), device=device)
    tm = (torch.arange(c.text_len)[None] < torch.as_tensor(rs.randint(8, c.text_len, B))[:, None])
    proms = torch.as_tensor(rs.randint(0, 1024, (B, 256, 8)), device=device)
    pm = (torch.arange(256)[None] < torch.as_tensor(rs.randint(100, 256, B))[:, None])
    gen = make_sharded_generate(model, mesh, lambda m, *a, **k: m.generate_maskgit(
        *a, steps=12, resp_bucket=c.serving_resp_bucket, **k))
    with torch.no_grad():
        out = gen(text, tm.float().to(device), proms, pm.float().to(device),
                  [seed + i for i in range(B)])
    return out.cpu().numpy()


def synthesizer(device, tiny: bool, seed: int, mesh_tp: int):
    """A fp32 ``Synthesizer`` over seeded main-path models at full width
    (``smoke.full_models``), sharded over ``mesh_tp`` ranks."""
    from .codec.encodec import Codec
    from .convert import init_seeded
    from .serve import Synthesizer
    from .smoke import default_symmap, full_models, tiny_models

    first, nar, _, codec_model = (tiny_models if tiny else full_models)(dtype=torch.float32)
    init_seeded(first.denoiser, seed)
    init_seeded(nar, seed + 1)
    init_seeded(codec_model, seed + 2)
    return Synthesizer(first, nar, Codec(codec_model, device), default_symmap(), device=device,
                       max_batch=4, bf16=False, mesh_tp=mesh_tp)


def serve_codes(synth, requests) -> tuple[np.ndarray, np.ndarray, float, int]:
    """One device batch of the requests through the main path (codes and
    wavs) → (codes, wavs, seconds, prompt bucket); a follower runs the
    batch it is sent."""
    prepared = [synth.prepare(t, r) for t, r, _ in requests]
    t0 = time.perf_counter()
    codes, wavs = synth._device_batch(prepared, [s for _, _, s in requests], want_wav=True)
    return (np.stack(codes), np.stack(wavs), time.perf_counter() - t0,
            synth.prompt_bucket(prepared))


# ---------------- the ranks ----------------

def run_nccl1(args, out: Path) -> dict:
    """A world of one: the D3PM steps and the MaskGIT batch without a
    process group, then inside one (NCCL on the card)."""
    import torch.distributed as dist

    from .parallel.mesh import build_mesh
    from .utils import distributed
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    rec = {}
    sizes = SIZES["tiny" if args.tiny else "full"]
    for label in ("no group", "group"):
        if label == "group":
            check(distributed.init_distributed(args.device), "no process group came up")
            x = torch.arange(4.0, device=device)
            dist.all_reduce(x)
            rec["backend"] = distributed.backend()
            rec["collective"] = x.tolist()
        mesh = build_mesh(-1, 1)
        rec[label] = {"train": train_steps(D3PM_YAML, mesh, device, args.tiny, sizes["d3pm"],
                                           args.seed, zero1=True, save=None),
                      "codes": maskgit_codes(mesh, device, args.tiny, 4, args.seed).tolist()}
    return rec


def run_gloo2(args, out: Path) -> dict:
    """Two ranks of one card over gloo: (a)–(d) of the module docstring,
    each path's kernel counts from 0."""
    from .parallel.mesh import build_mesh
    from .smoke import full_fp32, make_requests
    from .utils import distributed
    from .utils.device import resolve_device

    check(distributed.init_distributed(args.device), "no process group came up")
    device = resolve_device(args.device)
    rank = distributed.global_rank()
    sizes = SIZES["tiny" if args.tiny else "full"]
    dp, tp = build_mesh(2, 1), build_mesh(1, 2)
    rec = {"backend": distributed.backend()}
    rec["gloo_cuda"] = gloo_collectives_on(device, dp.dp)
    paths = (("dp2 d3pm", lambda: train_steps(D3PM_YAML, dp, device, args.tiny, sizes["d3pm"],
                                               args.seed, save=out / "dp2_d3pm.pt")),
             ("dp2 d3pm zero1", lambda: train_steps(D3PM_YAML, dp, device, args.tiny,
                                                     sizes["d3pm"], args.seed, zero1=True,
                                                     save=out / "dp2_d3pm_zero1.pt")),
             ("tp2 nar", lambda: train_steps(NAR_YAML, tp, device, args.tiny, sizes["nar"],
                                             args.seed, save=out / "tp2_nar.pt")))
    with full_fp32():
        for name, fn in paths:
            zero_counts()
            rec[name] = fn()
            rec[name]["counts"] = read_counts(device)
        synth = synthesizer(device, args.tiny, args.seed, mesh_tp=2)
        if synth.is_follower:
            zero_counts()
            rec["tp2 serve"] = {"batches": synth.follow()}
            rec["tp2 serve"]["counts"] = read_counts(device)
        else:
            requests = make_requests(sizes["serve"], 3.0, args.seed)
            zero_counts()
            codes, wavs, secs, pb = serve_codes(synth, requests)
            rec["tp2 serve"] = {"seconds": secs, "counts": read_counts(device),
                                "finite": bool(np.isfinite(wavs).all()), "prompt_bucket": pb}
            synth.stop_followers()
            np.save(out / "tp2_serve_codes.npy", codes)
        del synth
        zero_counts()
        codes = maskgit_codes(dp, device, args.tiny, 4, args.seed)
        rec["dp2 generate"] = {"codes": codes.tolist(), "counts": read_counts(device)}
    rec["rank"] = rank
    return rec


def gloo_collectives_on(device, axis) -> dict:
    """Which collectives the backend takes for tensors on ``device``
    (all-reduce, broadcast, and ``parallel/comm``'s all-gather and
    reduce-scatter): "ok" or the error."""
    import torch.distributed as dist

    from .parallel import comm

    x = torch.arange(12.0, device=device).reshape(4, 3) * (axis.rank + 1) - 5
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=axis.group),
        "broadcast": lambda: dist.broadcast(x.clone(), src=dist.get_global_rank(axis.group, 0),
                                            group=axis.group),
        "all_gather_into_tensor": lambda: comm.all_gather(x, axis, 1),
        "reduce_scatter_tensor": lambda: comm.reduce_scatter(x, axis, 0),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 — the probe's answer is the error
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        dist.barrier(group=axis.group)
    return out


def worker(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("scenario", choices=("nccl1", "gloo2"))
    p.add_argument("out", type=Path)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    rec = (run_nccl1 if args.scenario == "nccl1" else run_gloo2)(args, args.out)
    from .utils import distributed

    rank = distributed.global_rank()
    (args.out / f"{args.scenario}_rank{rank}.json").write_text(json.dumps(rec))
    distributed.barrier()
    distributed.shutdown_distributed()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario: str, world: int, out: Path, device, tiny: bool, seed: int) -> list[dict]:
    """``world`` ranks of a scenario, each with torchrun's environment; any
    rank failing or a timeout kills them all and fails the phase."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        if torch.device(device).type == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        argv = [sys.executable, "-m", f"{__package__}.smoke_parallel", scenario, str(out), "--device", str(device),
                "--seed", str(seed), *(["--tiny"] if tiny else [])]
        log_file = open(out / f"{scenario}_log{rank}.txt", "w")
        procs.append((subprocess.Popen(argv, env=env, stdout=log_file, stderr=subprocess.STDOUT,
                                       start_new_session=True), log_file))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    failed = []
    try:
        while any(p.poll() is None for p, _ in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.5)
    finally:
        for rank, (p, f) in enumerate(procs):
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
            f.close()
            if p.returncode != 0:
                failed.append(rank)
    if failed:
        tails = "\n".join(f"--- rank {r}:\n" + (out / f"{scenario}_log{r}.txt").read_text()[-4000:]
                          for r in failed)
        raise SmokeError(f"{scenario}: ranks {failed} failed\n{tails}")
    return [json.loads((out / f"{scenario}_rank{r}.json").read_text()) for r in range(world)]


# ---------------- the phase ----------------

def _close(got: dict, ref: dict, steps: int, lr: float) -> float:
    """max over parameters of max|got − ref| / max(1, |ref|), the DiT's key
    biases held to 2·lr·steps instead; raises past either bound."""
    worst = 0.0
    for k, r in ref.items():
        d = float((got[k].float() - r.float()).abs().max())
        if k.endswith(".k.bias"):
            check(d <= 2 * lr * steps, f"{k}: {d} > 2·lr·steps")
            continue
        worst = max(worst, d / max(1.0, float(r.float().abs().max())))
    check(worst <= PARAM_TOL, f"parameters differ by {worst} > {PARAM_TOL}·max(1, |ref|)")
    return worst


def p50(xs) -> float:
    return float(np.median(xs))


def _meta_recipe(yaml: Path, tiny: bool):
    from .config import Config
    from .train.train import build_model

    cfg = Config.from_cli([f"yaml={yaml}", *([f"model_overrides={TINY_MODEL}"] if tiny else [])])
    with torch.device("meta"):
        return cfg, build_model(cfg)


def train_sites(yaml: Path, tiny: bool, B: int, tp: int, path: str):
    """The training kernel's sites of one step at a rank's shapes: the
    recipe's sites (``smoke_train.step_sites``) at ``B`` rows and its heads
    over ``tp``."""
    from .smoke_train import step_sites

    cfg, model = _meta_recipe(yaml, tiny)
    return [dataclasses.replace(s, B=B, H=s.H // tp, path=path) for s in step_sites(model, cfg)]


def serve_sites(tiny: bool, prompt_bucket: int, tp: int, recipe_dit: bool = False):
    """The serving kernel's sites of one main-path batch (``smoke.attention_sites``,
    12 MaskGIT steps) with the heads over ``tp``; with ``recipe_dit``, of
    the D3PM recipe's DiT alone (``maskgit_codes``)."""
    from .smoke import attention_sites, full_models, tiny_models

    with torch.device("meta"):
        first, _, nar_dims, _ = (tiny_models if tiny else full_models)(dtype=torch.float32)
    dit_cfg = _meta_recipe(D3PM_YAML, tiny)[1].config if recipe_dit else first.config
    sites = attention_sites(dit_cfg, nar_dims, 12, prompt_bucket)
    return [dataclasses.replace(s, H=s.H // tp) for s in sites
            if not (recipe_dit and s.name.startswith("NAR"))]


def check_shapes(name: str, rec_counts: dict, want: Counter, key: str):
    got = Counter({tuple(s): n for s, n in rec_counts[key]})
    check(got == want, f"{name}: recorded kernel shapes {dict(got)} != the path's sites "
                       f"{dict(want)}")


def kernel_paths(device, ranks, tiny: bool, seed: int) -> dict:
    """Each parallel path's launches per rank against its sites, both
    kernels against their plain versions at every per-rank shape (fp32 and
    bf16, timed in bf16), and the paths' sums for the kernels' JSON line."""
    from .smoke import batch_totals, phase_site_check
    from .smoke_train import phase_train_kernel_check

    sizes = SIZES["tiny" if tiny else "full"]
    on_card = device.type == "cuda"
    pb = ranks[0]["tp2 serve"]["prompt_bucket"]
    # (rows per rank, sites): the serving batch pads to max_batch 4
    paths1 = {"tp2 serve": (4, serve_sites(tiny, pb, 2)),
              "dp2 generate": (2, serve_sites(tiny, 256, 1, recipe_dit=True))}
    paths2 = {"dp2 d3pm": train_sites(D3PM_YAML, tiny, sizes["d3pm"] // 2, 1, "parallel dp2 d3pm"),
              "tp2 nar": train_sites(NAR_YAML, tiny, sizes["nar"], 2, "parallel tp2 nar")}
    out = {"kernel1": [], "paths1": {}, "kernel2": [], "runs2": []}
    for name, (B, sites) in paths1.items():
        want = Counter()
        for s in sites:
            want[B, s.Tq, s.H, s.Dh, s.Tk] += s.count
        total = sum(want.values())
        for r in ranks:
            c = r[name]["counts"]
            check_shapes(f"{name} rank {r['rank']}", c, want, "shapes1")
            if on_card:
                check(c["kernel1"] == total and c["plain"] == 0,
                      f"{name} rank {r['rank']}: kernel-1 launches {c['kernel1']} (plain "
                      f"{c['plain']}) != {total}")
        timed = []
        for s in sites:
            res = phase_site_check(device, dataclasses.replace(s, name=f"parallel {name} {s.name}"),
                                   B, seed)
            out["kernel1"] += res
            timed += [dict(x, count=s.count) for x in res]
        out["paths1"][f"parallel {name}"] = dict(batch_totals(timed),
                                                 launches_run=ranks[0][name]["counts"]["kernel1"])
        log(f"parallel {name}: kernel-1 launches per rank {[r[name]['counts']['kernel1'] for r in ranks]}"
            f" (want {total})")
    for name, sites in paths2.items():
        fwd, bwd = sum(s.fwd for s in sites), sum(s.bwd for s in sites)
        want = Counter()
        for s in sites:
            want[s.B, s.Tq, s.H, s.Dh, s.Tk, s.causal] += s.fwd * STEPS
        for r in ranks:
            check_shapes(f"{name} rank {r['rank']}", r[name]["counts"], want, "shapes2")
            if on_card:
                check(all(tuple(x) == (fwd, bwd) for x in r[name]["launches"]),
                      f"{name} rank {r['rank']}: kernel-2 launches per step {r[name]['launches']}"
                      f" != {fwd}+{bwd}")
        out["kernel2"] += phase_train_kernel_check(device, sites, seed=seed)
        c = ranks[0][name]["counts"]
        out["runs2"].append((f"parallel {name}", fwd, bwd, c["kernel2_fwd"] + c["kernel2_bwd"]))
        log(f"parallel {name}: kernel-2 launches per rank per step "
            f"{[r[name]['launches'][0] for r in ranks]} (want {fwd}+{bwd})")
    return out


def phase_parallel(device, seed: int = 0, smi: str = "n/a", tiny: bool = False) -> dict:
    """The phase (see the module docstring) → the kernel checks' results and
    each parallel path's launches for the kernels' JSON line."""
    from .config import Config
    from .parallel.mesh import build_mesh
    from .smoke import full_fp32, make_requests

    on_card = device.type == "cuda"
    out = SMOKE_DIR / "parallel"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    sizes = SIZES["tiny" if tiny else "full"]
    where = f"on {smi}" if on_card else "on the CPU (plain versions)"

    # NCCL (gloo on the CPU), a world of one
    r1 = spawn("nccl1", 1, out, device, tiny, seed)[0]
    log(f"parallel: world of one over {r1['backend']}; all_reduce {r1['collective']}")
    a, b = r1["no group"], r1["group"]
    check(a["train"]["digests"] == b["train"]["digests"],
          "params with a process group differ from the run without one")
    check(a["codes"] == b["codes"], "MaskGIT codes with a process group differ")
    log(f"parallel: world of one, D3PM zero1 step p50 {p50(a['train']['step_s'][1:]) * 1e3:.1f} ms "
        f"without a group, {p50(b['train']['step_s'][1:]) * 1e3:.1f} ms in one "
        f"({r1['backend']}), params and codes bit-identical, {where}")

    # gloo, two ranks on the card
    t0 = time.perf_counter()
    ranks = spawn("gloo2", 2, out, device, tiny, seed)
    log(f"parallel: two ranks over {ranks[0]['backend']} ran in "
        f"{time.perf_counter() - t0:.1f} s; gloo with {device.type} tensors: {ranks[0]['gloo_cuda']}")
    check(all(v == "ok" for r in ranks for v in r["gloo_cuda"].values()),
          f"a collective failed on {device.type} tensors: {[r['gloo_cuda'] for r in ranks]}")
    lr = None
    with full_fp32():
        refs = {}
        for name, yaml, B in (("d3pm", D3PM_YAML, sizes["d3pm"]), ("nar", NAR_YAML, sizes["nar"])):
            path = out / f"ref_{name}.pt"
            refs[name] = train_steps(yaml, build_mesh(1, 1), device, tiny, B, seed, save=path)
            refs[name]["params"] = torch.load(path, weights_only=True)
        lr = max(Config.from_cli([f"yaml={y}"]).warmup_max_lr for y in (D3PM_YAML, NAR_YAML))
        synth = synthesizer(device, tiny, seed, mesh_tp=1)
        ref_codes, _, ref_s, _ = serve_codes(synth, make_requests(sizes["serve"], 3.0, seed))
        del synth
        ref_gen = maskgit_codes(build_mesh(1, 1), device, tiny, 4, seed)

    for name, ref_name in (("dp2 d3pm", "d3pm"), ("dp2 d3pm zero1", "d3pm"), ("tp2 nar", "nar")):
        got = torch.load(out / f"{name.replace(' ', '_')}.pt", weights_only=True)
        worst = _close(got, refs[ref_name]["params"], STEPS, lr)
        np.testing.assert_allclose(ranks[0][name]["losses"], refs[ref_name]["losses"], rtol=1e-5)
        if name.startswith("dp2"):
            check(ranks[0][name]["digests"] == ranks[1][name]["digests"],
                  f"{name}: params differ across the dp group")
        log(f"parallel {name}: params within {worst:.3e}·max(1, |ref|) of one process's after "
            f"{STEPS} steps; step p50 {p50(ranks[0][name]['step_s'][1:]) * 1e3:.1f} ms ({GLOO_LABEL}) "
            f"against {p50(refs[ref_name]['step_s'][1:]) * 1e3:.1f} ms in one process, {where}")
    zb = [r["dp2 d3pm zero1"]["moment_bytes"] for r in ranks]
    full_bytes = refs["d3pm"]["moment_bytes"]
    largest = max(2 * v.numel() * 4 for v in refs["d3pm"]["params"].values())
    check(all(z <= full_bytes / 2 + largest for z in zb),
          f"ZeRO-1 moment bytes {zb} > half of {full_bytes} + {largest}")
    log(f"parallel zero1: Adam moment bytes per rank {zb} against {full_bytes} replicated")
    codes_tp = np.load(out / "tp2_serve_codes.npy")
    check(np.array_equal(codes_tp, ref_codes), "tp=2 serving codes differ from mesh_tp=1")
    check(ranks[0]["tp2 serve"]["finite"], "tp=2 serving wavs are not finite")
    for r in ranks:
        check(np.array_equal(np.asarray(r["dp2 generate"]["codes"]), ref_gen),
              f"dp=2 MaskGIT codes on rank {r['rank']} differ from one process's")
    log(f"parallel: tp=2 serving codes ({codes_tp.shape}) and dp=2 MaskGIT codes identical to one "
        f"process's; tp=2 batch {ranks[0]['tp2 serve']['seconds'] * 1e3:.1f} ms ({GLOO_LABEL}) "
        f"against {ref_s * 1e3:.1f} ms, {where}")
    with full_fp32():
        return kernel_paths(device, ranks, tiny, seed)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("nccl1", "gloo2"):
        return worker(argv)
    p = argparse.ArgumentParser(description="the chip phase 'parallel' alone")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    from .smoke import phase, phase_build, phase_device
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    info = phase_device(device)
    if device.type == "cuda":
        with phase("build"):
            phase_build(device)
    with phase("parallel"):
        phase_parallel(device, args.seed, info["smi"], args.tiny)
    return 0


if __name__ == "__main__":
    sys.exit(main())
