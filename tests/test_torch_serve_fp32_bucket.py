"""The serving batch bucket: a lone bf16 request runs at batch 1, a lone
request with fp32 weights at ``max_batch``, so that in fp32 its codes equal
its codes in a full cohort bit for bit (GEMMs, reductions and convolutions
round by shape).  A tiny conv-UNet Gaussian first stage and a tiny NAR on
the CPU, seeded weights; imports neither jax nor the JAX package."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tts_with_diffusion_model_tpu_torch.convert import init_seeded
from tts_with_diffusion_model_tpu_torch.models import get_model
from tts_with_diffusion_model_tpu_torch.serve import Synthesizer
from tts_with_diffusion_model_tpu_torch.smoke import default_symmap

TINY = dict(d_model=32, n_heads=1, n_layers=2, timesteps=3, text_len=24, prom_len=64,
            resp_len=48, gen_len=40, unet_channels=[8, 16])


@pytest.mark.parametrize("bf16, lone_batch", [(False, 4), (True, 1)])
def test_a_lone_request_takes_the_max_batch_bucket_in_fp32(bf16, lone_batch):
    first = get_model("diffusion-gaussian-unet2d", 1024, TINY, dtype=torch.float32)
    init_seeded(first.denoiser, 1)
    nar = get_model("nar", 1024, dict(d_model=32, n_heads=2, n_layers=1), dtype=torch.float32)
    init_seeded(nar, 2)
    synth = Synthesizer(first, nar, None, default_symmap(), device="cpu", bf16=bf16, max_batch=4)
    rs = np.random.RandomState(0)
    rows = [synth._prepare_ids(list(rs.randint(1, 40, 8 + 3 * i)), rs.randint(0, 1024, (40, 8)))
            for i in range(4)]
    seeds = [11, 18, 25, 32]
    batches = []
    generate = first.generate

    def counted(text, *args, **kw):
        batches.append(text.shape[0])
        return generate(text, *args, **kw)

    first.generate = counted
    alone = synth._device_batch(rows[3:], seeds[3:], want_wav=False)[0][0]
    cohort = synth._device_batch(rows, seeds, want_wav=False)[0][3]
    assert batches == [lone_batch, 4]
    assert alone.shape == cohort.shape == (TINY["gen_len"], 8)
    if not bf16:
        assert np.array_equal(alone, cohort)
