"""EnCodec-24kHz-compatible codec: wav → RVQ codes and back (counterpart of
``codec/encodec.py`` in the JAX package).

24 kHz, hop 320 (ratios 8·5·4·2) → 75 frames/s; 8 active codebooks of 1024
codes.  Runs in fp32.  Layouts as in the JAX package: wav (B, T, 1), codes
(B, Q, frames).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from .rvq import ResidualVQ
from .seanet import SEANetDecoder, SEANetEncoder

_logger = logging.getLogger(__name__)

SAMPLE_RATE = 24_000
HOP = 320


class EncodecModel(nn.Module):
    def __init__(self, dimension: int = 128, n_filters: int = 32, n_q_total: int = 32,
                 bins: int = 1024):
        super().__init__()
        self.encoder = SEANetEncoder(dimension=dimension, n_filters=n_filters)
        self.decoder = SEANetDecoder(dimension=dimension, n_filters=n_filters)
        self.quantizer = ResidualVQ(n_q=n_q_total, bins=bins, dim=dimension)

    @torch.no_grad()
    def encode(self, wav, num_quantizers: int = 8):
        return self.quantizer.encode(self.encoder(wav), num_quantizers)

    @torch.no_grad()
    def decode(self, codes):
        return self.decoder(self.quantizer.decode(codes))


class Codec:
    """Host-facing codec: numpy in, numpy out, model on ``device``."""

    def __init__(self, model: EncodecModel, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    def encode(self, wav: np.ndarray, sr: int = SAMPLE_RATE, num_quantizers: int = 8) -> np.ndarray:
        """wav (T,) or (C, T) float → codes (num_quantizers, frames) int64."""
        from ..audio.wavio import convert_audio

        wav = convert_audio(wav, sr, SAMPLE_RATE, target_channels=1)
        x = torch.as_tensor(wav, dtype=torch.float32, device=self.device)[None, :, None]
        return self.model.encode(x, num_quantizers)[0].cpu().numpy()

    def decode(self, codes: np.ndarray) -> tuple[np.ndarray, int]:
        """codes (Q, frames) → (wav (T,), sr); (B, Q, frames) → ((B, T), sr)."""
        c = torch.as_tensor(np.asarray(codes), dtype=torch.long, device=self.device)
        batched = c.ndim == 3
        wav = self.model.decode(c if batched else c[None])[..., 0].cpu().numpy()
        return (wav if batched else wav[0]), SAMPLE_RATE


def find_weights(explicit: str | Path | None = None) -> Path | None:
    """``explicit`` (which must exist) or else the first converted-weights
    file that exists of ``$ENCODEC_WEIGHTS``, ``zoo/encodec_24khz.npz``
    (from the working directory) and the repository's
    ``zoo/encodec_24khz.npz``; None if none does."""
    import os

    if explicit is not None:
        if not Path(explicit).exists():
            raise FileNotFoundError(f"codec weights {explicit} not found")
        return Path(explicit)
    for cand in (os.environ.get("ENCODEC_WEIGHTS"), "zoo/encodec_24khz.npz",
                 Path(__file__).resolve().parents[2] / "zoo/encodec_24khz.npz"):
        if cand and Path(cand).exists():
            return Path(cand)
    return None


def load_codec(weights_path: str | Path | None, device="cuda", seed: int = 0) -> Codec:
    """Codec with the converted weights at ``weights_path`` (an ``.npz`` of
    flax paths, e.g. ``zoo/encodec_24khz.npz``), or with weights drawn from
    ``seed`` when ``weights_path`` is None."""
    from ..bundle import load_npz
    from ..convert import init_seeded, jax_params_to_torch

    model = EncodecModel()
    if weights_path is None:
        init_seeded(model, seed)
        _logger.warning("codec weights drawn from seed %d (not pretrained)", seed)
        return Codec(model, device)
    jax_params_to_torch(load_npz(weights_path), model)
    _logger.info("codec weights loaded from %s", weights_path)
    return Codec(model, device)
