"""Iteration-gated artifact saving (counterpart of ``utils/artifacts.py`` in
the JAX package, ≡ ``vall_e/utils/artifacts.py``).

``is_saving`` is true on the local leader every ``save_artifacts_every``
steps; artifacts land under ``log_dir/artifacts/<name>/<step:06d>.<ext>``:
figures, wavs and t-SNE plots of embedding rows (scikit-learn's t-SNE, with
a PCA fallback where scikit-learn is missing).  The JAX package reads the
step and config from its trainer's module state; here the caller passes
them (``cfg``: anything with ``log_dir`` and ``save_artifacts_every``).

The figure paths import matplotlib (and scikit-learn) only when called:
neither is a dependency of the card's paths.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from .distributed import is_local_leader

_logger = logging.getLogger(__name__)


def is_saving(cfg, step: int | None, every: int | None = None) -> bool:
    """Whether this step saves artifacts (``every`` defaults to
    ``cfg.save_artifacts_every``; 0 or None never)."""
    if step is None or not is_local_leader():
        return False
    if every is None:
        every = getattr(cfg, "save_artifacts_every", None)
    return bool(every) and step % every == 0


def get_path(cfg, step: int | None, name: str, suffix: str) -> Path:
    """``log_dir/artifacts/<name>/<step:06d><suffix>``, its folder made."""
    path = Path(cfg.log_dir) / "artifacts" / name / f"{step or 0:06d}{suffix}"
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def save_fig(cfg, step: int | None, name: str, fig) -> Path | None:
    """A matplotlib figure as ``.png`` on a saving step."""
    if not is_saving(cfg, step):
        return None
    path = get_path(cfg, step, name, ".png")
    fig.savefig(path, dpi=150)
    _logger.info(f"Saved artifact {path}")
    return path


def save_wav(cfg, step: int | None, name: str, wav: np.ndarray, sr: int = 24_000) -> Path | None:
    """A waveform as ``.wav`` on a saving step."""
    if not is_saving(cfg, step):
        return None
    from ..audio.wavio import write_wav

    path = get_path(cfg, step, name, ".wav")
    write_wav(path, wav, sr)
    _logger.info(f"Saved artifact {path}")
    return path


def embed_2d(x: np.ndarray, perplexity: float = 30.0) -> np.ndarray:
    """Rows of ``x`` → (N, 2): scikit-learn's t-SNE, or, where it cannot
    run, the projection on the first two principal axes (float64)."""
    try:
        from sklearn.manifold import TSNE

        return TSNE(n_components=2, perplexity=min(perplexity, max(2, len(x) / 4))
                    ).fit_transform(np.asarray(x, np.float32))
    except Exception as e:  # scikit-learn missing or refusing the input: PCA
        _logger.warning(f"t-SNE unavailable ({e}); falling back to PCA")
        xc = np.asarray(x, np.float64)
        xc = xc - xc.mean(0)
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        return xc @ vt[:2].T


def save_tsne(cfg, step: int | None, name: str, x: np.ndarray, labels=None,
              perplexity: float = 30.0) -> Path | None:
    """A scatter of ``embed_2d(x)``, coloured by ``labels``, as ``.png`` on
    a saving step (≡ ``artifacts.py:44-103``)."""
    if not is_saving(cfg, step):
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    emb = embed_2d(x, perplexity)
    fig, ax = plt.subplots(figsize=(6, 6))
    if labels is not None:
        uniq = sorted(set(labels))
        for u in uniq:
            m = np.array([lb == u for lb in labels])
            ax.scatter(emb[m, 0], emb[m, 1], s=8, label=str(u))
        if len(uniq) <= 20:
            ax.legend(fontsize=6)
    else:
        ax.scatter(emb[:, 0], emb[:, 1], s=8)
    path = get_path(cfg, step, name, ".png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    _logger.info(f"Saved artifact {path}")
    return path
