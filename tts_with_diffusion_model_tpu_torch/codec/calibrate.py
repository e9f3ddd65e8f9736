"""Residual k-means calibration of the RVQ codebooks (counterpart of
``codec/calibrate.py`` in the JAX package).

A random ``N(0, 1)`` codebook tiles the encoder's latents so badly that a
handful of codes take most frames; in an air-gapped deployment the codebooks
are fitted to data instead, level by level:

    residual_0 = encoder latents
    codebook_q = kmeans(residual_q, bins)
    residual_{q+1} = residual_q − codebook_q[assign(residual_q)]

which is the greedy objective RVQ decoding assumes.  The assignment is one
(N, D) @ (D, K) product per iteration on ``device``, in fp32 with TF32 off;
the seeding (k-means++ on numpy's ``default_rng(seed)``) and the centroid
update run on the host, as in the JAX package, so both give the same
codebooks for the same latents.

    python -m tts_with_diffusion_model_tpu_torch.codec.calibrate <wav folder> \\
        --out zoo/encodec_calibrated.npz [--levels 8] [--iters 12] [--device cuda]

The codec is found as ``emb.qnt`` finds it (``$ENCODEC_WEIGHTS``,
``zoo/encodec_24khz.npz``, else weights drawn from seed 0); the output is a
whole codec parameter file in the converted-weights format, so point
``$ENCODEC_WEIGHTS`` at it before ``emb.qnt``.
"""

from __future__ import annotations

import argparse
import copy
import logging
import time
from pathlib import Path

import numpy as np
import torch

_logger = logging.getLogger(__name__)


def _assign(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids: x (N, D), codebook (K, D), on one device →
    (N,) int64 (argmin of |c|² − 2·x·c), fp32 with TF32 off."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dots = torch.matmul(x, codebook.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    sq = (codebook ** 2).sum(dim=-1)
    return torch.argmin(sq - 2.0 * dots, dim=-1)


def kmeans(x: np.ndarray, k: int, iters: int, seed: int, device="cuda") -> np.ndarray:
    """Lloyd's k-means with k-means++ seeding and empty-cluster reseeding:
    x (N, D) float32 → centroids (K, D) float32, deterministic for a given
    (x, k, iters, seed).  The assignment runs on ``device``; the seeding and
    the update are the JAX package's numpy code."""
    n, d = x.shape
    rng = np.random.default_rng(seed)
    if n >= k:
        # k-means++ (each next centroid drawn ∝ squared distance to the
        # nearest chosen one), distances in the ‖x‖² − 2x·c + ‖c‖² form,
        # sampling by inverting the CDF
        centroids = np.empty((k, d), np.float32)
        centroids[0] = x[rng.integers(n)]
        x64 = x.astype(np.float64)
        x_sq = (x64 ** 2).sum(-1)
        c = centroids[0].astype(np.float64)
        min_d2 = np.maximum(x_sq - 2.0 * (x64 @ c) + (c ** 2).sum(), 0.0)
        for i in range(1, k):
            total = min_d2.sum()
            if total <= 0:
                j = int(rng.integers(n))
            else:
                j = int(np.searchsorted(np.cumsum(min_d2), rng.uniform(0.0, total)))
                j = min(j, n - 1)
            centroids[i] = x[j]
            c = x64[j]
            d2 = x_sq - 2.0 * (x64 @ c) + (c ** 2).sum()
            np.minimum(min_d2, np.maximum(d2, 0.0), out=min_d2)
    else:
        # degenerate corpus: tile the points, jitter the copies apart
        reps = int(np.ceil(k / max(n, 1)))
        base = np.tile(x, (reps, 1))[:k]
        centroids = (base + 1e-3 * rng.standard_normal(base.shape)).astype(np.float32)
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    for _ in range(iters):
        idx = _assign(xt, torch.as_tensor(centroids, device=device)).cpu().numpy()
        # a bincount per dimension (the update stays on the host)
        sums = np.stack([np.bincount(idx, weights=x[:, di], minlength=k) for di in range(d)],
                        axis=1)
        counts = np.bincount(idx, minlength=k).astype(np.float64)
        nonempty = counts > 0
        centroids[nonempty] = (sums[nonempty] / counts[nonempty, None]).astype(np.float32)
        n_empty = int((~nonempty).sum())
        if n_empty:
            # reseed empty clusters at random points, jittered
            centroids[~nonempty] = x[rng.choice(n, size=n_empty)] \
                + 1e-4 * rng.standard_normal((n_empty, x.shape[1])).astype(np.float32)
    return centroids


def calibrate_codebooks(latents: np.ndarray, codebooks: np.ndarray, levels: int = 8,
                        iters: int = 12, seed: int = 0, device="cuda",
                        report: list | None = None) -> np.ndarray:
    """Fit the first ``levels`` RVQ codebooks to ``latents`` residually.
    latents (N, D); codebooks (n_q, K, D): the levels past ``levels`` are
    kept.  Returns a new codebook array; ``report`` (a list) gets one dict
    per level: the residual RMS after it, the codes it used and its
    seconds."""
    out = np.array(codebooks, np.float32, copy=True)
    residual = np.asarray(latents, np.float32)
    k = codebooks.shape[1]
    for q in range(levels):
        t0 = time.perf_counter()
        cb = kmeans(residual, k, iters, seed + q, device)
        out[q] = cb
        idx = _assign(torch.as_tensor(residual, device=device),
                      torch.as_tensor(cb, device=device)).cpu().numpy()
        residual = residual - cb[idx]
        rms = float(np.sqrt((residual ** 2).mean()))
        used = len(np.unique(idx))
        _logger.info(f"level {q}: residual RMS {rms:.4f}, codes used {used}/{k}")
        if report is not None:
            report.append({"level": q, "residual_rms": rms, "codes_used": used,
                           "seconds": time.perf_counter() - t0})
    return out


def collect_latents(codec, wav_paths, max_frames: int = 400_000, seed: int = 0) -> np.ndarray:
    """Encoder latents of a corpus, in the JAX package's order (the paths
    shuffled by ``default_rng(seed)``), until ``max_frames`` rows; then a
    random subsample of ``max_frames`` rows if over."""
    from ..audio.wavio import read_wav

    rng = np.random.default_rng(seed)
    paths = list(wav_paths)
    rng.shuffle(paths)
    chunks, total = [], 0
    for p in paths:
        wav, sr = read_wav(p)
        if wav.ndim == 2:
            wav = wav[0]
        z = codec.encode_latents(wav, sr)  # (frames, D)
        chunks.append(np.asarray(z, np.float32))
        total += z.shape[0]
        if total >= max_frames:
            break
    x = np.concatenate(chunks, axis=0)
    if x.shape[0] > max_frames:
        x = x[rng.choice(x.shape[0], size=max_frames, replace=False)]
    return x


CODEBOOKS = "params/quantizer/codebooks"


def calibrate_codec_params(flat: dict, latents: np.ndarray, levels: int = 8, iters: int = 12,
                           seed: int = 0, device="cuda", report: list | None = None) -> dict:
    """A copy of the codec's converted parameters (``{"params/...": array}``)
    with calibrated quantizer codebooks."""
    new = copy.deepcopy(flat)
    new[CODEBOOKS] = calibrate_codebooks(latents, np.asarray(flat[CODEBOOKS]), levels=levels,
                                         iters=iters, seed=seed, device=device, report=report)
    return new


def main(argv: list[str] | None = None) -> dict:
    """The CLI; returns {"out", "latents", "levels"} (one dict per level)."""
    from . import encodec
    from .convert import codec_params, save_npz_params

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Fit the codec's RVQ codebooks to a wav corpus.")
    ap.add_argument("folder", type=Path)
    ap.add_argument("--out", type=Path, default=Path("zoo/encodec_calibrated.npz"))
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--max-frames", type=int, default=400_000)
    ap.add_argument("--suffix", default=".wav")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    codec = encodec.load_codec(encodec.find_weights(), device=args.device)
    paths = sorted(args.folder.rglob(f"*{args.suffix}"))
    if not paths:
        raise SystemExit(f"no {args.suffix} files under {args.folder}")
    _logger.info(f"collecting latents from {len(paths)} wavs")
    latents = collect_latents(codec, paths, max_frames=args.max_frames)
    _logger.info(f"latents: {latents.shape}")
    levels: list = []
    new = calibrate_codec_params(codec_params(codec.model), latents, levels=args.levels,
                                 iters=args.iters, device=codec.device, report=levels)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    save_npz_params(new, args.out)
    print(f"calibrated codec written to {args.out}")
    return {"out": args.out, "latents": latents.shape, "levels": levels}


if __name__ == "__main__":
    main()
