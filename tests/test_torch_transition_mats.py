"""The D3PM's dense transition-matrix helpers against the JAX package's, bit
for bit (numpy, float64), and the port's structured one-step matrices
(``D3PM._structured_mats(cum=False)``) against them at each step's β."""

import numpy as np
import pytest

from tts_with_diffusion_model_tpu.diffusion.d3pm import (
    absorbing_transition_mat as jax_absorbing,
    uniform_transition_mat as jax_uniform,
)
from tts_with_diffusion_model_tpu_torch.diffusion.d3pm import (
    D3PM,
    absorbing_transition_mat,
    uniform_transition_mat,
)


@pytest.mark.parametrize("V", [2, 7, 1025])
@pytest.mark.parametrize("beta", [0.0, 0.01, 0.5, 1.0])
def test_helpers_equal_jax_bit_for_bit(beta, V):
    for got, want in ((absorbing_transition_mat(beta, V), jax_absorbing(beta, V)),
                      (uniform_transition_mat(beta, V), jax_uniform(beta, V))):
        assert got.dtype == want.dtype == np.float64 and got.shape == (V, V)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-12)


@pytest.mark.parametrize("transition", ["absorbing", "uniform"])
def test_structured_one_step_matrices_are_the_helpers_at_each_beta(transition):
    """The absorbing family bit for bit (the same two float64 operations);
    the uniform diagonal is (1 − β) + β/V there and 1 − β·(V − 1)/V in the
    helper, equal within float64 rounding."""
    d = D3PM.create(timesteps=12, num_classes=7, transition=transition)
    mats = d._structured_mats(cum=False)
    helper = absorbing_transition_mat if transition == "absorbing" else uniform_transition_mat
    for t in range(d.timesteps):
        want = helper(float(np.float64(d.betas[t])), d.num_classes)
        if transition == "absorbing":
            np.testing.assert_array_equal(mats[t], want)
        else:
            np.testing.assert_allclose(mats[t], want, rtol=0, atol=4e-16)
