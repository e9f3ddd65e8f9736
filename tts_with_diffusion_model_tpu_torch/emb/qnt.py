"""Codec preprocessor CLI and helpers (counterpart of ``emb/qnt.py`` in the
JAX package):

    python -m tts_with_diffusion_model_tpu_torch.emb.qnt <folder> [--suffix .wav] \\
        [--codec weights.npz] [--device cuda]

EnCodec-encodes every ``*<suffix>`` file under the folder (the first channel
of a stereo file) and writes ``<stem>.qnt.npy`` beside it, int16
``(8, frames)``; existing outputs are skipped.  The codec weights are the
first that exist of ``--codec``, ``$ENCODEC_WEIGHTS``,
``zoo/encodec_24khz.npz`` and the repository's ``zoo/encodec_24khz.npz``;
with none, the codec's weights are drawn from seed 0 (with a warning).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..audio.wavio import read_wav, write_wav
from ..codec.encodec import Codec, find_weights, load_codec


def encode(wav: np.ndarray, sr: int, codec: Codec) -> np.ndarray:
    """wav (C, T) or (T,) float → codes (8, frames)."""
    return codec.encode(wav, sr)


def decode(codes: np.ndarray, codec: Codec) -> tuple[np.ndarray, int]:
    """codes (q, t) or (b, q, t) → (wav, sample rate)."""
    return codec.decode(codes)


def encode_from_file(path: str | Path, codec: Codec) -> np.ndarray:
    wav, sr = read_wav(path)
    if wav.shape[0] == 2:
        wav = wav[:1]
    return encode(wav, sr, codec)


def decode_to_file(resps: np.ndarray, path: str | Path, codec: Codec) -> None:
    """resps: (t, q) codes → a wav file."""
    if np.ndim(resps) != 2:
        raise ValueError(f"need codes of shape (t, q), got {np.shape(resps)}")
    wav, sr = decode(np.asarray(resps).T, codec)
    write_wav(path, wav, sr)


def _replace_file_extension(path: Path, suffix: str) -> Path:
    return (path.parent / path.name.split(".")[0]).with_suffix(suffix)


def main(argv: list[str] | None = None) -> list[Path]:
    """→ the ``.qnt.npy`` files written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("folder", type=Path)
    parser.add_argument("--suffix", default=".wav")
    parser.add_argument("--codec", type=Path, default=None, help="converted EnCodec weights (.npz)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    codec = load_codec(find_weights(args.codec), device=args.device)
    written = []
    for path in sorted(args.folder.rglob(f"*{args.suffix}")):
        out_path = _replace_file_extension(path, ".qnt.npy")
        if out_path.exists():
            continue
        np.save(out_path, encode_from_file(path, codec).astype(np.int16))
        print(out_path)
        written.append(out_path)
    return written


if __name__ == "__main__":
    main()
