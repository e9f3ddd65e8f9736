"""Objective evaluation metrics for the eval loop (a copy of
``utils/metrics.py`` in the JAX package, numpy only, kept here because the
port imports nothing of that package).

  - **Per-level codec token accuracy**: the exact-match rate of generated
    RVQ codes against the reference utterance's codes (level 0 is what the
    first stage generates; levels 1-7 grade the NAR).
  - **Mel-cepstral distortion (MCD)** with DTW alignment (Kubichek 1993):
    mel cepstra per frame, dynamic-time-warp the two sequences, and average
    ``(10/ln10)·sqrt(2·Σ_d (c_h − c_r)²)`` over the aligned path.
  - **Seam spectral flux**: the roughness of long-form segment joins
    relative to the signal's own frame-to-frame variation.

Host-side numpy: eval batches are a few tens of utterances of a few hundred
frames, and none of this belongs on the card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# ---------------------------------------------------------------- tokens


def token_accuracy(
    hyp: np.ndarray, ref: np.ndarray, teacher_levels: int = 0
) -> dict:
    """Exact-match accuracy of codec codes, per RVQ level.

    Args:
        hyp: (t_h, L_h) int codes (generated).
        ref: (t_r, L_r) int codes (ground truth).
        teacher_levels: number of leading levels that were *given* to the
            model rather than generated (the NAR receives ground-truth
            level 0, so its level-0 "accuracy" is trivially 1.0).  These
            levels are reported as ``level{l}_acc_teacher`` and excluded
            from the aggregate ``acc``.
    Returns:
        dict with ``level{l}_acc`` for each common level, ``acc`` (mean
        over generated levels and frames), and ``len_ratio`` (t_h / t_r).
        Accuracy compares the first ``min(t_h, t_r)`` frames; a length
        mismatch is reported by ``len_ratio`` rather than counted as
        errors (alignment-free measure — MCD covers pacing).
    """
    hyp = np.asarray(hyp)
    ref = np.asarray(ref)
    if hyp.ndim != 2 or ref.ndim != 2:
        raise ValueError(f"need (t, L) codes, got {hyp.shape} vs {ref.shape}")
    t = min(hyp.shape[0], ref.shape[0])
    levels = min(hyp.shape[1], ref.shape[1])
    out: dict = {"len_ratio": float(hyp.shape[0] / max(ref.shape[0], 1))}
    if t == 0 or levels == 0:
        out["acc"] = 0.0
        return out
    eq = hyp[:t, :levels] == ref[:t, :levels]
    teacher_levels = min(int(teacher_levels), levels)
    for lv in range(levels):
        key = (f"level{lv}_acc_teacher" if lv < teacher_levels
               else f"level{lv}_acc")
        out[key] = float(eq[:, lv].mean())
    scored = eq[:, teacher_levels:]
    out["acc"] = float(scored.mean()) if scored.size else 0.0
    return out


# ---------------------------------------------------------------- cepstra


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Triangular mel filterbank (n_mels, n_fft//2 + 1), HTK mel scale."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, n_bins))
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def _frame(wav: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Center-padded frames (n_frames, n_fft)."""
    pad = n_fft // 2
    x = np.pad(wav.astype(np.float64), (pad, pad))
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return x[idx]


def mel_cepstra(
    wav: np.ndarray,
    sr: int,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 40,
    n_ceps: int = 13,
) -> np.ndarray:
    """Waveform → mel cepstra (n_frames, n_ceps), c1..c_n (c0/energy
    excluded, the MCD convention)."""
    wav = np.asarray(wav, np.float64).reshape(-1)
    if len(wav) < hop:
        wav = np.pad(wav, (0, hop - len(wav)))
    frames = _frame(wav, n_fft, hop) * np.hanning(n_fft)[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=-1))
    mel = mel_filterbank(sr, n_fft, n_mels) @ (mag.T ** 2)  # (n_mels, T)
    logmel = np.log(np.maximum(mel, 1e-10))
    # Orthonormal DCT-II rows 1..n_ceps.
    k = np.arange(n_mels)
    basis = np.cos(np.pi * np.outer(np.arange(1, n_ceps + 1), (k + 0.5)) / n_mels)
    basis *= np.sqrt(2.0 / n_mels)
    return (basis @ logmel).T  # (T, n_ceps)


def _dtw_path(cost: np.ndarray) -> list[tuple[int, int]]:
    """Monotone DTW path minimizing summed local cost (steps ←, ↑, ↖)."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        # vectorized row update is possible but the DP recurrence on the
        # same row forbids it; n,m are a few hundred — fine on host.
        row = acc[i]
        prev = acc[i - 1]
        ci = cost[i - 1]
        for j in range(1, m + 1):
            row[j] = ci[j - 1] + min(prev[j], row[j - 1], prev[j - 1])
    path = []
    i, j = n, m
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        a = int(np.argmin(moves))
        if a == 0:
            i, j = i - 1, j - 1
        elif a == 1:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return path


#: (10 / ln 10) · sqrt(2) — the constant in Kubichek's MCD-dB formula.
_MCD_K = (10.0 / np.log(10.0)) * np.sqrt(2.0)


def mel_cepstral_distortion(
    hyp_wav: np.ndarray,
    ref_wav: np.ndarray,
    sr: int,
    n_ceps: int = 13,
) -> dict:
    """MCD (dB) between two waveforms at the same sample rate.

    Returns ``{"mcd": dB, "frames": aligned-path length}``.  Lower is
    better; identical signals give 0; typical good TTS lands ~4-8 dB.
    """
    ch = mel_cepstra(hyp_wav, sr, n_ceps=n_ceps)
    cr = mel_cepstra(ref_wav, sr, n_ceps=n_ceps)
    if len(ch) == 0 or len(cr) == 0:
        return {"mcd": float("inf"), "frames": 0}
    # local cost: per-frame MCD contribution (before the path average)
    d2 = ((ch[:, None, :] - cr[None, :, :]) ** 2).sum(-1)
    local = _MCD_K * np.sqrt(d2)
    path = _dtw_path(local)
    mcd = float(np.mean([local[i, j] for i, j in path]))
    return {"mcd": mcd, "frames": len(path)}


def seam_spectral_flux(
    wav: np.ndarray,
    sr: int,
    boundary_samples: Sequence[int],
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 40,
) -> dict:
    """Spectral discontinuity at segment joins, relative to the signal's
    own frame-to-frame variation.

    Long-form synthesis (``longform.py``) chains fixed-bucket segments and
    decodes the concatenated code stream in one convolutional pass,
    claiming seam-free joins.  This measures that claim: for each boundary
    (sample offset of a join), take the log-mel spectral flux
    ``‖logmel[i+1] − logmel[i]‖₂`` over the frames straddling the join and
    divide by the median flux across the whole signal.  A ratio ≈ 1 means
    a join is no rougher than ordinary signal evolution; audible splice
    clicks show up as ratios ≫ 1.

    Returns ``{"seam_flux_ratios": [...], "seam_flux_ratio_max": r,
    "seam_flux_ratio_mean": r, "flux_median": m}``.
    """
    wav = np.asarray(wav, np.float64).reshape(-1)
    frames = _frame(wav, n_fft, hop) * np.hanning(n_fft)[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=-1))
    mel = mel_filterbank(sr, n_fft, n_mels) @ (mag.T ** 2)  # (n_mels, T)
    logmel = np.log(np.maximum(mel, 1e-10)).T  # (T, n_mels)
    if logmel.shape[0] < 3:
        return {"seam_flux_ratios": [], "seam_flux_ratio_max": 0.0,
                "seam_flux_ratio_mean": 0.0, "flux_median": 0.0}
    flux = np.linalg.norm(np.diff(logmel, axis=0), axis=-1)  # (T-1,)
    baseline = float(np.median(flux))
    ratios = []
    for s in boundary_samples:
        b = int(round(s / hop))
        lo = max(0, b - 2)
        hi = min(len(flux), b + 2)
        if lo >= hi:
            continue
        ratios.append(float(flux[lo:hi].max() / max(baseline, 1e-10)))
    return {
        "seam_flux_ratios": ratios,
        "seam_flux_ratio_max": float(max(ratios)) if ratios else 0.0,
        "seam_flux_ratio_mean": float(np.mean(ratios)) if ratios else 0.0,
        "flux_median": baseline,
    }


def eval_utterance_metrics(
    hyp_codes: np.ndarray,
    ref_codes: np.ndarray,
    hyp_wav: np.ndarray | None = None,
    ref_wav: np.ndarray | None = None,
    sr: int = 24_000,
    teacher_levels: int = 0,
) -> dict:
    """All objective metrics for one eval utterance (codes + optional wavs)."""
    out = token_accuracy(hyp_codes, ref_codes, teacher_levels=teacher_levels)
    if hyp_wav is not None and ref_wav is not None:
        out.update(mel_cepstral_distortion(hyp_wav, ref_wav, sr))
    return out


def aggregate_metrics(rows: list[dict]) -> dict:
    """Mean of every finite numeric field across utterances, plus count."""
    out: dict = {"n_utts": len(rows)}
    if not rows:
        return out
    keys = sorted({k for r in rows for k in r})
    for k in keys:
        vals = [float(r[k]) for r in rows if k in r and np.isfinite(r[k])]
        if vals:
            out[k] = float(np.mean(vals))
    return out
