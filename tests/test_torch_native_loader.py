"""The port's native C++ loader binding and dataset cache against the JAX
package's, on the CPU: the npy parser against numpy; with one worker and
the same seed, the same batches as JAX's ``NativeDataLoader`` (alone and
inside ``LengthBucketedLoader``) over a seeded corpus; JAX's batch contract
with two workers; which loader ``create_train_val_dataloader`` takes; where
the library is built; and ``cache_dataloader``'s file, equal to JAX's."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu.config import Config as JaxConfig
from tts_with_diffusion_model_tpu.config import make_spkr_getter
from tts_with_diffusion_model_tpu.data import dataset as jax_dataset
from tts_with_diffusion_model_tpu.data import native_loader as jax_native
from tts_with_diffusion_model_tpu_torch import smoke_train
from tts_with_diffusion_model_tpu_torch.config import Config
from tts_with_diffusion_model_tpu_torch.data import dataset, native_loader
from tts_with_diffusion_model_tpu_torch.ops._build import BUILD_DIR

REPO = Path(__file__).resolve().parents[1]
GET_SPKR = make_spkr_getter("parts:-2")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_corpus")
    smoke_train.write_train_corpus(root, n_speakers=3, n_utts=10, seed=0, frames=(10, 60),
                                   phones=(3, 20))
    return root


def _datasets(corpus, module):
    paths, _ = module.load_train_val_paths([corpus], GET_SPKR)
    return module.VALLEDataset(paths, GET_SPKR, min_phones=3, max_phones=100, training=True,
                               max_prompts=3)


def _same_batches(got, ref):
    for gb, rb in zip(got, ref):
        assert gb.keys() == rb.keys()
        for k in rb:
            if isinstance(rb[k], np.ndarray):
                np.testing.assert_array_equal(gb[k], rb[k], err_msg=k)
            else:
                assert [str(x) for x in gb[k]] == [str(x) for x in rb[k]], k


def test_native_load_npy_matches_numpy(tmp_path):
    for dtype in (np.int16, np.int32, np.int64):
        arr = (np.arange(24, dtype=dtype) - 7).reshape(3, 8)
        p = tmp_path / f"{np.dtype(dtype).name}.npy"
        np.save(p, arr)
        np.testing.assert_array_equal(native_loader.native_load_npy(p), arr.astype(np.int32))


@pytest.mark.parametrize("buckets", [None, [24, 40]])
def test_one_worker_batches_equal_jax(corpus, buckets):
    """n_workers 1, the same seed: identical batches (paths, speakers,
    every array), also re-grouped by ``LengthBucketedLoader``."""
    bucket = (16, 96, 64)
    ours = native_loader.NativeDataLoader(_datasets(corpus, dataset), 4,
                                          dataset.BucketSpec(*bucket), n_workers=1, seed=11)
    ref = jax_native.NativeDataLoader(_datasets(corpus, jax_dataset), 4,
                                      jax_dataset.BucketSpec(*bucket), n_workers=1, seed=11)
    try:
        if buckets:
            ours_it = iter(dataset.LengthBucketedLoader(ours, ours.bucket, buckets,
                                                        prom_buckets=[48], window=3, seed=2))
            ref_it = iter(jax_dataset.LengthBucketedLoader(ref, ref.bucket, buckets,
                                                           prom_buckets=[48], window=3, seed=2))
        else:
            ours_it, ref_it = iter(ours), iter(ref)
        _same_batches([next(ours_it) for _ in range(7)], [next(ref_it) for _ in range(7)])
    finally:
        ours.close()
        ref.close()


def test_two_worker_batch_contract(corpus):
    """JAX's contract (tests/test_native_loader.py): shapes, prefix masks,
    phones and prompts present, resp = level 0, every speaker drawn."""
    dl = native_loader.NativeDataLoader(_datasets(corpus, dataset), 4,
                                        dataset.BucketSpec(32, 96, 64), n_workers=2, seed=7)
    it, seen = iter(dl), set()
    try:
        for _ in range(8):
            b = next(it)
            assert b["text"].shape == (4, 32) and b["proms"].shape == (4, 96, 8)
            assert b["resps"].shape == (4, 64, 8)
            for i in range(4):
                n = int(b["resp_mask"][i].sum())
                assert (b["resp_mask"][i, :n] == 1).all() and (b["resp_mask"][i, n:] == 0).all()
                nt = int(b["text_mask"][i].sum())
                assert nt >= 3 and (b["text"][i, :nt] > 0).all()
                assert b["prom_mask"][i].sum() > 0
                assert (b["proms"][i] >= 0).all() and (b["proms"][i] < 1024).all()
            seen.update(b["spkr_name"])
            np.testing.assert_array_equal(b["resp"], b["resps"][..., 0])
    finally:
        dl.close()
    dl.close()  # idempotent
    assert seen == {"spk0", "spk1", "spk2"}


def _cfg(corpus, **kw):
    return Config(**{**dict(data_dirs=[corpus], spkr_name_getter="parts:-2", min_phones=3,
                            batch_size=4, eval_batch_size=4, nj=2, max_num_val=6, max_prompts=3,
                            seed=5), **kw})


@pytest.mark.parametrize("native,buckets", [(True, None), (True, [24]), (False, None)])
def test_create_train_val_dataloader_takes_the_native_loader_by_default(corpus, native, buckets):
    kw = {} if native else {"use_native_loader": False}
    train_dl, _, _ = dataset.create_train_val_dataloader(
        _cfg(corpus, resp_len_buckets=buckets, **kw), dataset.BucketSpec(16, 96, 48))
    assert train_dl.kind == ("native" if native else "python")
    assert isinstance(train_dl, dataset.LengthBucketedLoader if buckets else
                      (native_loader.NativeDataLoader if native else dataset.DataLoader))
    it = iter(train_dl)
    assert next(it)["text"].shape == (4, 16)
    it.close()
    if native:
        train_dl.close()


def test_python_loader_without_npy_or_gxx(corpus, tmp_path, monkeypatch):
    """JAX's two reasons for the Python loader: no .qnt.npy (a .qnt.pt
    corpus), no g++."""
    pt_root = tmp_path / "pt" / "spk0"
    pt_root.mkdir(parents=True)
    for i, src in enumerate(sorted((corpus / "spk0").glob("*.qnt.npy"))[:6]):
        torch.save(torch.from_numpy(np.load(src).astype(np.int64))[None], pt_root / f"u{i}.qnt.pt")
        (pt_root / f"u{i}.phn.txt").write_text(src.with_name(src.name.replace(".qnt.npy",
                                                                              ".phn.txt")).read_text())
    train_dl, _, _ = dataset.create_train_val_dataloader(
        _cfg(tmp_path / "pt", nj=1), dataset.BucketSpec(16, 96, 48))
    assert train_dl.kind == "python"

    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "library_path", lambda: tmp_path / "absent.so")
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    train_dl, _, _ = dataset.create_train_val_dataloader(_cfg(corpus), dataset.BucketSpec(16, 96, 48))
    assert train_dl.kind == "python"


def test_library_is_built_into_build_torch_kernels(monkeypatch):
    """The library is named by its source and flags under
    build/torch_kernels/; a build writes nothing under native/."""
    path = native_loader.library_path()
    assert path.parent == BUILD_DIR == REPO / "build" / "torch_kernels"
    assert path.name.startswith("libdataloader-") and path.suffix == ".so"
    assert native_loader.library_path() == path
    monkeypatch.setattr(native_loader, "FLAGS", native_loader.FLAGS + ("-g",))
    assert native_loader.library_path() != path
    monkeypatch.undo()

    commands = []
    real_run = native_loader.subprocess.run

    def run(cmd, **kw):
        commands.append(cmd)
        return real_run(cmd, **kw)

    built = native_loader.build_library()
    assert built == path and built.exists()
    monkeypatch.setattr(native_loader, "library_path",
                        lambda: BUILD_DIR / f"libdataloader-test-{os.getpid()}.so")
    monkeypatch.setattr(native_loader.subprocess, "run", run)
    fresh = native_loader.build_library()
    try:
        assert fresh.exists() and len(commands) == 1
        assert Path(commands[0][-1]).parent == BUILD_DIR  # g++ -o <build/torch_kernels/...>
    finally:
        fresh.unlink()
    # native/ holds the source and at most the JAX package's own library
    assert {p.name for p in (REPO / "native").iterdir()} <= {"dataloader.cc", "libdataloader.so"}


def test_cache_dataloader_file_equals_jax(corpus, tmp_path, monkeypatch):
    """Same cfg → the same cache file name and JSON; a second build restores
    the same paths and symmaps without validating them again."""
    monkeypatch.chdir(tmp_path)
    kw = dict(data_dirs=[corpus], spkr_name_getter="parts:-2", min_phones=3, max_num_val=6,
              cache_dataloader=True, cfg_name="cached")
    ours, ref = Config(**kw), JaxConfig(**kw)
    assert dataset._dataset_cache_file(ours) == jax_dataset._dataset_cache_file(ref)
    path = dataset._dataset_cache_file(ours)
    ref_train, ref_val = jax_dataset.create_datasets(ref)
    ref_blob = path.read_text()
    path.unlink()
    train, val = dataset.create_datasets(ours)
    assert path.read_text() == ref_blob
    monkeypatch.setattr(dataset, "validate_path", lambda *a: pytest.fail("validated again"))
    train2, val2 = dataset.create_datasets(ours)
    for a, b, r in ((train, train2, ref_train), (val, val2, ref_val)):
        assert a.paths == b.paths and [str(p) for p in a.paths] == [str(p) for p in r.paths]
        assert a.phone_symmap == b.phone_symmap == r.phone_symmap
        assert a.spkr_symmap == b.spkr_symmap == r.spkr_symmap
        assert len(a) == len(b)
    assert json.loads(ref_blob)["val_paths"] == [str(p) for p in val.paths]
