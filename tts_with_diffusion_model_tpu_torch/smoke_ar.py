"""The AR serving phase of the port's smoke run (``chip_smoke.py`` drives it
on the card after "export -> serve"; the CPU tests rehearse it at a tiny
size with the plain versions).

8. export → serve ar — the AR's train run exported by the export CLI
   (``--ema``) and held bit for bit against the engine's EMA; a
   ``Synthesizer`` over it and the NAR bundle of phase 7 answering
   ``TEXTS`` at ``max_ar_steps`` 448 and temperature 1.0, with the kernels'
   launches per batch checked (kernel 2's forward for the prefill, one per
   AR block; kernel 1 for the NAR, 7 per NAR block; no plain call on the
   card), the codes, lengths and wavs checked, and the prefill's logits
   held against the plain attention; then speculative decoding: in fp32
   with TF32 off, greedy speculative (k = 4) must equal plain greedy token
   for token with the target as its own draft and with a seeded
   ``ar-quarter`` draft, and in bf16 the same comparison is printed.
"""

from __future__ import annotations

import time
from unittest import mock

import numpy as np
import torch

from .ops import masked_attention as serve_ops
from .ops import train_flash_attention as train_ops
from .smoke import SMOKE_DIR, TEXTS, TOL, Site, _sync, check, full_fp32, log, make_requests
from .smoke_export import check_round_trip, export_run

#: the serving bucket of the AR's response (and the NAR's at the AR path)
MAX_STEPS = 448
SPEC_K = 4
#: the seeded ar-quarter draft's comparison runs this many steps: nearly
#: every proposal of a random draft is rejected, one token per round
QUARTER_STEPS = 64


def nar_site(text_len: int, prompt_bucket: int, max_steps: int, nar_dims: dict) -> Site:
    """Kernel 1's site on the AR path: the NAR's packed self-attention over
    text + sep + prompt + sep + the ``max_steps`` response bucket."""
    T = text_len + 1 + prompt_bucket + 1 + max_steps
    H = nar_dims["n_heads"]
    return Site("NAR packed self (ar serve)", T, T, H, nar_dims["d_model"] // H,
                7 * nar_dims["n_layers"])


def _counts():
    fa, ma = train_ops.train_flash_attention, serve_ops.masked_attention
    return {"kernel2": fa.launches, "kernel2_bwd": fa.backward_launches,
            "kernel2_plain": fa.plain_calls, "kernel1": ma.launches, "kernel1_plain": ma.plain_calls}


def _reset_counts():
    fa, ma = train_ops.train_flash_attention, serve_ops.masked_attention
    fa.launches = fa.backward_launches = fa.plain_calls = 0
    ma.launches = ma.plain_calls = 0


def batch_tensors(synth, prepared):
    """The device tensors of a batch of prepared rows, as the Synthesizer
    stacks them: text, text mask, and the prompt and its mask cut to the
    cohort's prompt bucket."""
    dev = synth.device
    pb = synth.prompt_bucket(prepared)

    def stack(key):
        return torch.as_tensor(np.concatenate([r[key] for r in prepared]), device=dev)

    return (stack("text"), stack("text_mask"), stack("proms")[:, :pb],
            stack("prom_mask")[:, :pb].contiguous())


def serve_ar_and_check(synth, requests, label: str, repeats: int = 3) -> dict:
    """One AR batch with the kernel counts set to 0 just before and read
    just after; the launches, codes, lengths and wavs checked; the same
    seeds again; the prefill's logits kernel vs plain; the AR first stage
    timed alone; and the p50 of ``repeats`` more batches."""
    from .models.ar import ar_generate
    from .utils.rng import RowKeys

    device = synth.device
    on_card = device.type == "cuda"
    prepared = [synth.prepare(t, r) for t, r, _ in requests]
    seeds = [s for _, _, s in requests]
    pb = synth.prompt_bucket(prepared)
    want = {"kernel2": synth.first.base.n_layers, "kernel1": 7 * synth.nar.base.n_layers}

    _reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    codes, wavs = synth._device_batch(prepared, seeds, want_wav=True)
    _sync(device)
    first_s = time.perf_counter() - t0
    c = _counts()
    lens = [len(x) for x in codes]
    log(f"{label}: first AR batch of {len(requests)} in {first_s:.3f} s; prompt bucket {pb}; "
        f"lengths {lens}; kernel 2 forwards {c['kernel2']} (plain {c['kernel2_plain']}), "
        f"kernel 1 launches {c['kernel1']} (plain {c['kernel1_plain']}); expected "
        f"{want['kernel2']} and {want['kernel1']} per batch")
    if on_card:
        check(c["kernel2"] == want["kernel2"] and c["kernel1"] == want["kernel1"],
              f"{label}: launches {c} != {want}")
        check(c["kernel2_plain"] == c["kernel1_plain"] == c["kernel2_bwd"] == 0,
              f"{label}: a plain version or a backward ran on the card: {c}")
    else:
        check(c["kernel2_plain"] == want["kernel2"] and c["kernel1_plain"] == want["kernel1"],
              f"{label}: plain calls {c} != {want}")
    for i, (x, w) in enumerate(zip(codes, wavs)):
        check(1 <= len(x) <= synth.max_ar_steps and x.shape[1:] == (8,),
              f"request {i}: codes {x.shape}, max_ar_steps {synth.max_ar_steps}")
        check(int(x.min()) >= 0 and int(x.max()) < 1024, f"request {i}: codes outside [0, 1024)")
        check(w.shape == (len(x) * 320,), f"request {i}: wav {w.shape} != {(len(x) * 320,)}")
        check(bool(np.isfinite(w).all()), f"request {i}: non-finite samples")
    codes2, _ = synth._device_batch(prepared, seeds, want_wav=False)
    check(all(np.array_equal(a, b) for a, b in zip(codes, codes2)),
          f"{label}: a second run with the same seeds gave other codes")

    text, tm, proms, pm = batch_tensors(synth, prepared)
    err, scale = prefill_kernel_vs_plain(synth.first, text, tm, proms, pm)
    log(f"{label}: AR prefill logits kernel vs plain max abs err {err:.4g} (max |logit| "
        f"{scale:.4g})")
    check(err <= TOL[torch.bfloat16] * max(1.0, scale),
          f"AR prefill kernel vs plain: {err:.4g} > {TOL[torch.bfloat16]} x max(1, {scale:.4g})")

    keys = RowKeys.from_seeds(seeds).fold(0)
    _sync(device)
    t1 = time.perf_counter()
    toks, ar_lens = ar_generate(synth.first, text, tm, proms, pm, keys,
                                max_steps=synth.max_ar_steps, sampling_temperature=synth.temperature)
    _sync(device)
    ar_s = time.perf_counter() - t1
    longest = max(int(ar_lens.max()), 1)
    log(f"{label}: AR first stage alone {ar_s * 1e3:.1f} ms, longest row {longest} of "
        f"{synth.max_ar_steps}: {ar_s * 1e3 / longest:.2f} ms per token position (host clock)")

    times = []
    for _ in range(repeats):
        _sync(device)
        t2 = time.perf_counter()
        synth.synthesize_batch(requests)
        _sync(device)
        times.append(time.perf_counter() - t2)
    p50 = float(np.median(times))
    log(f"{label}: AR synthesize_batch of {len(requests)} p50 {p50 * 1e3:.1f} ms over {repeats} "
        f"({'host clock around synchronised work' if on_card else 'cpu, not a device time'})")
    return {"launches": c, "expected": want, "lengths": lens, "p50_s": p50, "first_s": first_s,
            "times_s": times, "ar_s": ar_s, "prompt_bucket": pb, "prefill_err": err,
            "codes": codes, "prepared": prepared, "seeds": seeds}


@torch.no_grad()
def prefill_kernel_vs_plain(model, text, tm, proms, pm) -> tuple[float, float]:
    """The prefill's last logits with kernel 2's forward, then with the plain
    version on the same device → (max |Δ|, max |logits|)."""
    P = text.shape[1] + 1 + proms.shape[1] + 1
    counts = _counts()
    got, _ = model.prefill(text, tm, proms, pm, P)
    with mock.patch.object(train_ops, "train_flash_attention",
                           train_ops.train_flash_attention_plain):
        ref, _ = model.prefill(text, tm, proms, pm, P)
    fa = train_ops.train_flash_attention
    fa.launches, fa.plain_calls = counts["kernel2"], counts["kernel2_plain"]
    return (got - ref).abs().max().item(), ref.abs().max().item()


def first_divergence(a_toks, a_lens, b_toks, b_lens):
    """(row, position) of the first token where two decodes of one batch
    differ (in tokens or length), or None."""
    for b in range(a_toks.shape[0]):
        n = max(int(a_lens[b]), int(b_lens[b]), 1)
        diff = torch.nonzero(a_toks[b, :n] != b_toks[b, :n])
        if len(diff) or int(a_lens[b]) != int(b_lens[b]):
            return b, int(diff[0]) if len(diff) else min(int(a_lens[b]), int(b_lens[b]))
    return None


def spec_stats(stats, k: int) -> dict:
    """A speculative batch's rounds, and per row (averaged) the tokens
    committed per round after the first and the share of drafted tokens
    kept, as the JAX package's record defines them."""
    committed, rounds = stats["committed"].float(), max(int(stats["rounds"]), 1)
    return {"rounds": int(stats["rounds"]),
            "accepted_per_round": float(((committed - 1) / rounds).mean()),
            "acceptance_rate": float(((committed - rounds - 1).clamp(min=0) / (rounds * k)).mean())}


@torch.no_grad()
def top2_margin(model, batch, toks, row: int, pos: int) -> float:
    """Top-2 margin of ``model``'s teacher-forced logits for token ``pos``
    of a batch row, fed ``toks[row, :pos]`` before it."""
    text, tm, proms, pm = (x[row:row + 1] for x in batch)
    P = text.shape[1] + 1 + proms.shape[1] + 1
    resp = toks[row:row + 1, :pos]
    logits, _ = model(text, tm, proms, pm, resp, torch.ones(resp.shape, device=resp.device))
    top2 = logits[0, P - 1 + pos].float().topk(2).values
    return float(top2[0] - top2[1])


def compare_speculative(target, draft, batch, max_steps: int, k: int, label: str,
                        assert_equal: bool, margin_model=None) -> dict:
    """Greedy speculative against plain greedy on one batch; kernel-2
    forwards counted over the speculative call.  ``assert_equal`` fails on
    any difference; otherwise the first divergence is printed with the top-2
    margin of ``margin_model``'s teacher-forced logits there."""
    from .models.ar import ar_generate, ar_generate_speculative

    dev = batch[0].device
    plain, plain_lens = ar_generate(target, *batch, None, max_steps=max_steps,
                                    sampling_temperature=0.0)
    _reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    toks, lens, stats = ar_generate_speculative(target, draft, *batch, None, max_steps=max_steps,
                                                k=k, with_stats=True)
    _sync(dev)
    secs = time.perf_counter() - t0
    launched = _counts()
    div = first_divergence(plain, plain_lens, toks, lens)
    out = {"identical": div is None, "first_divergence": div, "seconds": secs,
           "lengths": lens.tolist(), "kernel2": launched["kernel2"],
           "kernel2_plain": launched["kernel2_plain"], **spec_stats(stats, k)}
    if div is not None and margin_model is not None:
        out["tie_margin"] = top2_margin(margin_model, batch, plain, *div)
    margin = f" (fp32 top-2 margin {out['tie_margin']:.4g})" if "tie_margin" in out else ""
    log(f"{label}: identical {out['identical']}, first divergence {div}{margin}; "
        f"rounds {out['rounds']}, accepted per round {out['accepted_per_round']:.2f}, "
        f"acceptance rate {out['acceptance_rate']:.3f}; {secs:.2f} s; kernel 2 forwards "
        f"{launched['kernel2']} (plain {launched['kernel2_plain']})")
    if assert_equal:
        check(div is None, f"{label}: speculative differs from plain greedy at {div}")
    return out


def speculative_checks(synth, bundle, prepared, seed: int, max_steps: int = MAX_STEPS,
                       quarter_steps: int = QUARTER_STEPS, k: int = SPEC_K,
                       quarter_overrides: dict | None = None) -> dict:
    """fp32 (TF32 off): the target as its own draft at ``max_steps`` and a
    seeded ``ar-quarter`` draft at ``quarter_steps``, asserted equal to
    plain greedy; bf16 (the serving weights): the same, printed."""
    from .convert import init_seeded
    from .utils.precision import cast_params_bf16
    from .models import get_model
    from .serve import load_model

    device = synth.device
    n_layers = synth.first.base.n_layers
    out = {}
    with full_fp32():
        target = load_model(bundle, torch.float32)[0].to(device).eval()
        quarter = get_model("ar-quarter", target.n_tokens, quarter_overrides, dtype=torch.float32)
        init_seeded(quarter, seed + 7)
        quarter = quarter.to(device).eval()
        batch = batch_tensors(synth, prepared)
        out["fp32 self"] = compare_speculative(target, target, batch, max_steps, k,
                                               "spec fp32, target as draft", True)
        out["fp32 quarter"] = compare_speculative(target, quarter, batch, quarter_steps, k,
                                                  "spec fp32, seeded ar-quarter draft", True)
        want = n_layers + quarter.base.n_layers
        got = out["fp32 quarter"]["kernel2" if device.type == "cuda" else "kernel2_plain"]
        check(got == want, f"speculative with the quarter draft: {got} prefill forwards != {want}")
        quarter16 = get_model("ar-quarter", target.n_tokens, quarter_overrides)
        init_seeded(quarter16, seed + 7)
        quarter16 = cast_params_bf16(quarter16.to(device).eval())
        out["bf16 self"] = compare_speculative(synth.first, synth.first, batch, max_steps, k,
                                               "spec bf16, target as draft (printed)", False,
                                               margin_model=target)
        out["bf16 quarter"] = compare_speculative(synth.first, quarter16, batch, quarter_steps, k,
                                                  "spec bf16, seeded ar-quarter draft (printed)",
                                                  False, margin_model=target)
    return out


def phase_export_serve_ar(device, ar_argv: list[str], nar_bundle, step: int, seed: int = 0,
                          repeats: int = 3, ref_seconds: float = 3.0, codec=None,
                          max_steps: int = MAX_STEPS, quarter_steps: int = QUARTER_STEPS,
                          quarter_overrides: dict | None = None, profile: bool = False) -> dict:
    """Export the AR run at ``step``, check the round trip, serve ``TEXTS``
    through it and ``nar_bundle`` (``serve_ar_and_check``), then the
    speculative comparisons; ``codec`` replaces ``from_bundles``'s (the CPU
    rehearsal's small one); ``profile`` traces one more AR batch."""
    from .serve import Synthesizer

    e = export_run(ar_argv, SMOKE_DIR / "export" / "ar", step)
    e["params"] = check_round_trip(ar_argv, e["path"], step)
    log(f"export ar: {e['path']} in {e['seconds']:.2f} s, {e['bytes']} bytes; {e['params']} "
        "parameters equal to the engine's EMA bit for bit (f32)")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    synth = Synthesizer.from_bundles(e["path"], nar_bundle, None, device=device,
                                     max_batch=len(TEXTS), max_ar_steps=max_steps,
                                     temperature=1.0)
    if codec is not None:
        synth.codec = codec
    log(f"export ar: Synthesizer over the exported AR and NAR on {device} in "
        f"{time.perf_counter() - t0:.2f} s")
    requests = make_requests(len(TEXTS), ref_seconds, seed)
    served = serve_ar_and_check(synth, requests, "export ar", repeats)
    if profile:
        from .smoke import profile_call

        served["profile"] = profile_call(lambda: synth.synthesize_batch(requests),
                                         "ar serving batch")
    spec = speculative_checks(synth, e["path"], served["prepared"], seed, max_steps,
                              quarter_steps, quarter_overrides=quarter_overrides)
    return {"export": e, "served": served, "spec": spec}
