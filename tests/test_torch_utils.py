"""The port's ``utils/helpers``, ``utils/precision`` and ``utils/artifacts``
against the JAX package's on the CPU: tree helpers, the device transfers,
the bf16 serving cast in its one home, and the artifact paths, gating and
the t-SNE plot's PCA fallback (the figure paths run on the CPU only)."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.utils import helpers as jh
from tts_with_diffusion_model_tpu_torch import convert
from tts_with_diffusion_model_tpu_torch.utils import artifacts, helpers, precision


def test_tree_helpers_match_jax():
    tree = {"a": {"b": 1, "c": [2, (3, {"d": 4})]}, "e": np.arange(3)}
    for sep in (".", "/"):
        got, ref = helpers.flatten_dict(tree, sep), jh.flatten_dict(tree, sep)
        assert list(got) == list(ref) and all(got[k] is ref[k] for k in ref)
    fn = lambda x: x * 2 if isinstance(x, int) else x  # noqa: E731
    assert helpers.tree_map(fn, tree)["a"] == jh.tree_map(fn, tree)["a"]


def test_to_device_and_to_numpy():
    tree = {"x": np.arange(4, dtype=np.float32), "y": [torch.ones(2), "keep"]}
    moved = helpers.to_device(tree, "cpu")
    assert isinstance(moved["x"], torch.Tensor) and moved["y"][1] == "keep"
    back = helpers.to_numpy(moved)
    np.testing.assert_array_equal(back["x"], tree["x"])
    assert isinstance(back["y"][0], np.ndarray)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            helpers.to_device(tree)


def test_cast_params_bf16_lives_in_utils_precision():
    """One home for the serving cast: ``convert`` no longer has it."""
    assert not hasattr(convert, "cast_params_bf16")
    layer = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
    layer.add_module("norm_w", torch.nn.Linear(4, 4))
    precision.cast_params_bf16(layer)
    dt = {n: p.dtype for n, p in layer.named_parameters()}
    assert dt == {"0.weight": torch.bfloat16, "0.bias": torch.float32, "1.weight": torch.float32,
                  "1.bias": torch.float32, "norm_w.weight": torch.float32,
                  "norm_w.bias": torch.float32}


@pytest.fixture
def jax_trainer(monkeypatch, tmp_path):
    """The JAX package's trainer state that its artifacts read, and the
    same step and config for the port's."""
    from tts_with_diffusion_model_tpu.train import trainer

    cfg = SimpleNamespace(log_dir=tmp_path / "log", save_artifacts_every=5)
    state = SimpleNamespace(global_step=10, cfg=cfg)
    monkeypatch.setattr(trainer, "_engines", state)
    return state


def test_artifact_paths_and_gating_match_jax(jax_trainer, monkeypatch):
    from tts_with_diffusion_model_tpu.utils import artifacts as ja

    cfg = jax_trainer.cfg
    for step in (10, 11):
        jax_trainer.global_step = step
        assert artifacts.is_saving(cfg, step) == ja.is_saving()
        assert artifacts.is_saving(cfg, step, every=11) == ja.is_saving(every=11)
    assert artifacts.get_path(cfg, 11, "x", ".png") == ja.get_path("x", ".png")
    jax_trainer.global_step = 10
    wav = np.sin(np.arange(2400) / 10).astype(np.float32)
    assert artifacts.save_wav(cfg, 10, "w", wav) == ja.save_wav("w", wav)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert not artifacts.is_saving(cfg, 10) and not ja.is_saving()


def test_tsne_pca_fallback_matches_jax(jax_trainer, monkeypatch):
    """Without scikit-learn both plot the projection on the first two
    principal axes: the points each scatter call draws agree within 1e-9."""
    import matplotlib.pyplot as plt

    from tts_with_diffusion_model_tpu.utils import artifacts as ja

    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    drawn = []
    real = plt.subplots

    def recording_subplots(*a, **kw):
        fig, ax = real(*a, **kw)
        scatter = ax.scatter
        ax.scatter = lambda x, y, **k: (drawn[-1].append(np.stack([x, y], 1)), scatter(x, y, **k))
        return fig, ax

    monkeypatch.setattr(plt, "subplots", recording_subplots)
    x = np.random.RandomState(0).randn(30, 6)
    labels = ["a", "b", "c"] * 10
    paths = []
    for save in (lambda: artifacts.save_tsne(jax_trainer.cfg, 10, "e", x, labels),
                 lambda: ja.save_tsne("e", x, labels)):
        drawn.append([])
        paths.append(save())
    assert paths[0] == paths[1] and paths[0].exists()
    assert len(drawn[0]) == len(drawn[1]) == 3
    for a, b in zip(*drawn):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
