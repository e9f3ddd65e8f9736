"""The kernel build's cache key (``ops/_build.library_path``): a library is
named by a hash of its source, the ``csrc/*.cuh`` headers that source
includes, and the flags, so a library built against an older header is
never loaded.  Runs on the CPU: nothing is compiled."""

import shutil

import pytest

from tts_with_diffusion_model_tpu_torch.ops import _build

KERNELS = ("masked_attention", "train_flash_attention")


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


@pytest.mark.parametrize("name", KERNELS)
def test_unchanged_tree_gives_the_same_library(csrc, name):
    assert _build.library_path(name, csrc) == _build.library_path(name, csrc)
    assert _build.library_path(name, csrc) == _build.library_path(name)


@pytest.mark.parametrize("name", KERNELS)
def test_editing_the_shared_header_changes_the_library(csrc, name):
    before = _build.library_path(name, csrc)
    header = csrc / "hopper_attention.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name, csrc) != before


@pytest.mark.parametrize("name", KERNELS)
def test_sources_include_the_shared_header(name):
    deps = _build.local_headers(_build.CSRC / f"{name}.cu")
    assert [d.name for d in deps] == ["hopper_attention.cuh"]


def test_editing_one_source_leaves_the_other_library(csrc):
    before = {n: _build.library_path(n, csrc) for n in KERNELS}
    src = csrc / "masked_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("masked_attention", csrc) != before["masked_attention"]
    assert _build.library_path("train_flash_attention", csrc) == before["train_flash_attention"]


def test_flags_and_include_dirs_are_part_of_the_key(csrc, monkeypatch):
    before = _build.library_path("masked_attention", csrc)
    monkeypatch.setattr(_build, "INCLUDES", ("-I/somewhere/include",))
    with_include = _build.library_path("masked_attention", csrc)
    monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ("-lineinfo",))
    assert len({before, with_include, _build.library_path("masked_attention", csrc)}) == 3

