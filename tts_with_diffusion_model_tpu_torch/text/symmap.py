"""Symbol-map handling as explicit serialized artifacts: a copy of
``text/symmap.py`` in the JAX package (importing that package imports jax).

The reference pickles symmaps onto exported model objects
(``export.py:18-19``) and reads them back via attribute access
(``__main__.py:56``).  Here symmaps are first-class JSON artifacts inside
the inference bundle (SURVEY §7.1) — explicit, diffable, and independent of
any pickle format.
"""

from __future__ import annotations

import json
from pathlib import Path


def save_symmap(symmap: dict[str, int], path: str | Path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(symmap, indent=1, sort_keys=True))


def load_symmap(path: str | Path) -> dict[str, int]:
    return {str(k): int(v) for k, v in json.loads(Path(path).read_text()).items()}


def phones_to_ids(
    phones: list[str], symmap: dict[str, int], strict: bool = True
) -> list[int]:
    """Map phones to ids.  Unknown phones fall back to ``<unk>`` when
    present; otherwise ``strict=True`` raises (the reference raises KeyError
    implicitly, ``__main__.py:61``) and ``strict=False`` drops them with a
    warning (the CLI uses this so a small training symmap still synthesizes)."""
    import logging

    out = []
    dropped = []
    for p in phones:
        if p in symmap:
            out.append(symmap[p])
        elif "<unk>" in symmap:
            out.append(symmap["<unk>"])
        elif strict:
            raise KeyError(f"Phone {p!r} not in symmap")
        else:
            dropped.append(p)
    if dropped:
        logging.getLogger(__name__).warning(
            f"Dropped {len(dropped)} phones not in symmap: {sorted(set(dropped))}"
        )
    return out
