"""``scripts/kernel_variants.py`` on the CPU: each variant's edit finds its
text exactly once in the sources it edits (so the script times what it
names), and without a card the script refuses to run."""

from __future__ import annotations

import pytest

from tts_with_diffusion_model_tpu_torch.ops import _build
from tts_with_diffusion_model_tpu_torch.scripts import kernel_variants


@pytest.mark.parametrize("name, lib, edits", kernel_variants.VARIANTS,
                         ids=[f"{lib}-{name}" for name, lib, _ in kernel_variants.VARIANTS])
def test_each_edit_matches_its_source_once(name, lib, edits):
    assert (_build.CSRC / f"{lib}.cu").is_file()
    for fname, old, new in edits:
        assert old != new
        assert (_build.CSRC / fname).read_text().count(old) == 1, (name, fname, old)


def test_refuses_without_a_card(capsys):
    assert kernel_variants.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
