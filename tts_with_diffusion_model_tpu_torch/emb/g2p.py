"""G2P preprocessor CLI (counterpart of ``emb/g2p.py`` in the JAX package):

    python -m tts_with_diffusion_model_tpu_torch.emb.g2p <folder> [--suffix .normalized.txt]

reads every ``*<suffix>`` file under the folder and writes its phonemes,
space-joined, to ``<stem>.phn.txt`` beside it; existing outputs are skipped.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..text.g2p import encode  # noqa: F401 (re-export: emb.g2p.encode)


def main(argv: list[str] | None = None) -> list[Path]:
    """→ the ``.phn.txt`` files written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("folder", type=Path)
    parser.add_argument("--suffix", type=str, default=".normalized.txt")
    args = parser.parse_args(argv)

    written = []
    for path in sorted(args.folder.rglob(f"*{args.suffix}")):
        phone_path = path.with_name(path.stem.split(".")[0] + ".phn.txt")
        if phone_path.exists():
            continue
        phone_path.write_text(" ".join(encode(path.read_text(encoding="utf8"))))
        print(phone_path)
        written.append(phone_path)
    return written


if __name__ == "__main__":
    main()
