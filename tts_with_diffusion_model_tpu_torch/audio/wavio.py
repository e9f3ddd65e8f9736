"""Host-side audio I/O: WAV read/write + resampling.  A copy of
``audio/wavio.py`` in the JAX package (importing that package imports jax).

Replaces the reference's torchaudio/soundfile usage (``emb/qnt.py:64-73``,
``utils/artifacts.py:51-57``) with stdlib ``wave`` + numpy + scipy polyphase
resampling — audio I/O is host work, not a device workload (SURVEY §2.3).
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np
from scipy.signal import resample_poly


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file → (float32 (C, T) in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            a[:, 0].astype(np.int32)
            | (a[:, 1].astype(np.int32) << 8)
            | (a[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported sample width {width}")
    data = data.reshape(-1, n_ch).T  # (C, T)
    return np.ascontiguousarray(data), sr


def write_wav(path: str | Path, wav: np.ndarray, sr: int):
    """Write float (T,) or (C, T) audio in [-1, 1] as 16-bit PCM WAV."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.T.tobytes())


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if sr == target_sr:
        return wav
    g = np.gcd(sr, target_sr)
    return resample_poly(wav, target_sr // g, sr // g, axis=-1).astype(np.float32)


def convert_audio(
    wav: np.ndarray, sr: int, target_sr: int, target_channels: int = 1
) -> np.ndarray:
    """Channel mixdown + resample (≡ ``encodec.utils.convert_audio`` as used
    at ``emb/qnt.py:64``).  Returns (T,) for mono, (C, T) otherwise."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    if target_channels == 1:
        wav = wav.mean(axis=0, keepdims=True)
    elif wav.shape[0] == 1:
        wav = np.repeat(wav, target_channels, axis=0)
    wav = resample(wav, sr, target_sr)
    return wav[0] if target_channels == 1 else wav
