"""Codec training losses (counterpart of ``codec/losses.py`` in the JAX
package): L1 on the waveform, a multi-scale STFT loss (spectral convergence
plus log-magnitude L1 over a bank of FFT sizes, the non-adversarial part of
EnCodec's recipe) and the VQ codebook / commitment losses with
straight-through gradients.

The STFT is the JAX package's, not ``torch.stft``'s defaults: frames are cut
from the signal as it is (no centring, no padding) and windowed by the
symmetric Hann window (``numpy.hanning``); a scale longer than the signal is
skipped.
"""

from __future__ import annotations

import torch


def stft_mag(x: torch.Tensor, frame: int, hop: int) -> torch.Tensor:
    """Magnitude STFT of (B, T) → (B, 1 + (T − frame) // hop, frame//2 + 1)."""
    frames = x.unfold(-1, frame, hop)
    window = torch.hann_window(frame, periodic=False, dtype=x.dtype, device=x.device)
    return torch.fft.rfft(frames * window, dim=-1).abs()


def multiscale_stft_loss(x: torch.Tensor, y: torch.Tensor,
                         frame_sizes=(2048, 1024, 512, 256), eps: float = 1e-5) -> torch.Tensor:
    """Σ over scales of (spectral convergence + log-magnitude L1).  The
    spectral convergence is one Frobenius norm over the whole batch."""
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for frame in frame_sizes:
        if x.shape[-1] < frame:
            continue
        hop = frame // 4
        mx, my = stft_mag(x, frame, hop), stft_mag(y, frame, hop)
        sc = torch.linalg.vector_norm(mx - my) / torch.linalg.vector_norm(mx).clamp_min(eps)
        logmag = (torch.log(mx + eps) - torch.log(my + eps)).abs().mean()
        total = total + sc + logmag
    return total


def vq_losses(z: torch.Tensor, z_q: torch.Tensor, beta: float = 0.25):
    """VQ-VAE codebook and commitment losses of encoder latents ``z`` and
    their quantization ``z_q`` (before the straight-through) →
    (codebook_loss, beta · commitment_loss)."""
    codebook = ((z.detach() - z_q) ** 2).mean()
    commit = ((z - z_q.detach()) ** 2).mean()
    return codebook, beta * commit


def straight_through(z: torch.Tensor, z_q: torch.Tensor) -> torch.Tensor:
    """Forward ``z_q``, backward identity to ``z``."""
    return z + (z_q - z).detach()


def codec_reconstruction_loss(model, wav: torch.Tensor, num_quantizers: int = 8,
                              stft_weight: float = 1.0, l1_weight: float = 0.1):
    """The reconstruction objective through encoder → RVQ (straight-through)
    → decoder.  ``model``: an ``EncodecModel``; ``wav`` (B, T, 1) →
    (loss, {"stft", "l1", "codebook", "commit"})."""
    z = model.encode_latents(wav)
    z_q, _ = model.quantize_latents(z, num_quantizers)
    cb_loss, commit_loss = vq_losses(z, z_q)
    recon = model.decode_latents(straight_through(z, z_q))

    T = min(wav.shape[1], recon.shape[1])
    x, y = wav[:, :T, 0], recon[:, :T, 0]
    l1 = (x - y).abs().mean()
    spec = multiscale_stft_loss(x, y)

    loss = stft_weight * spec + l1_weight * l1 + cb_loss + commit_loss
    return loss, {"stft": spec, "l1": l1, "codebook": cb_loss, "commit": commit_loss}
