"""Hierarchical balanced sampler (copy of ``data/sampler.py`` in the JAX
package, ≡ ``vall_e/sampler.py:14-48``).

Builds a tree keyed by ``key_fns`` and samples uniformly at each level —
speaker-balanced sampling regardless of per-speaker utterance counts.  An
explicit ``random.Random`` makes the draws reproducible: with the same seed
the port draws the same utterances as the JAX package.
"""

from __future__ import annotations

import random
from typing import Callable, Sequence


class Sampler:
    def __init__(self, items: Sequence, key_fns: Sequence[Callable], rng: random.Random | None = None):
        self.rng = rng or random.Random()
        self.tree = self._build(list(items), list(key_fns))

    def _build(self, items, key_fns):
        if not key_fns:
            return items
        key_fn, *rest = key_fns
        tree: dict = {}
        for x in items:
            tree.setdefault(key_fn(x), []).append(x)
        return {k: self._build(v, rest) for k, v in tree.items()}

    def _sample(self, node):
        if isinstance(node, list):
            return self.rng.choice(node)
        key = self.rng.choice(sorted(node.keys()))
        return self._sample(node[key])

    def sample(self):
        return self._sample(self.tree)
