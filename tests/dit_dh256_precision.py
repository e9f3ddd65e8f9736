"""Where the Dh-256 DiT of ``test_torch_wide_heads.py`` loses fp32 precision,
against the float64 result of the same weights (the port in float64 with
every fp32 cast lifted, ``_precision``; it agrees with JAX in x64 to 6e-8).

Prints, as the largest error over the logits and every parameter's
gradient, each × 1 / max(1, max |ref|):

  1. JAX and the port in fp32 at the test's seeded weights;
  2. both again after a one-ulp change of every weight, over ten draws
     (the float64 reference recomputed at each);
  3. the port with the scores q·k of one attention computed in float64 and
     rounded once to fp32 (the prompt tower's first self-attention, then
     every attention).

Run on the CPU from the repository's root (about four minutes):

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/dit_dh256_precision.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_wide_heads as W
from torch_port_helpers import flatten, perturbed, t, unflatten
from tts_with_diffusion_model_tpu.models.dit import DiTDenoiser as JaxDiT
from tts_with_diffusion_model_tpu_torch.convert import jax_params_to_torch, torch_params_to_jax
from tts_with_diffusion_model_tpu_torch.models.dit import DiTDenoiser
from tts_with_diffusion_model_tpu_torch.ops import train_flash_attention as train_ops

KW = dict(n_classes=33, d_model=256, n_heads=1, n_layers=2, timesteps=10)
#: the prompt tower's first self-attention, in the port's call order
PROMPT_LAYER_0 = 2
BATCH = W._dit_batch(seed=1)
WEIGHTS = np.random.RandomState(2).randn(*BATCH[4].shape, 33)


def port(flat, dtype, plain=None):
    """The port's logits and gradients (flat, float64 arrays) at ``flat``,
    with ``plain`` standing in for the training attention's plain version."""
    mp = pytest.MonkeyPatch()
    if plain is not None:
        mp.setattr(train_ops, "train_flash_attention_plain", plain)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    td = DiTDenoiser(dtype=dtype, **KW).to(dtype)
    jax_params_to_torch({k: v.astype(np_dt) for k, v in flat.items()}, td)
    logits = td(*[t(a) for a in BATCH])
    (logits * t(WEIGHTS.astype(np_dt))).sum().backward()
    mp.undo()
    out = torch_params_to_jax(td, {n: p.grad for n, p in td.named_parameters()})
    out["logits"] = logits.detach()
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def reference(flat):
    """The port in float64 (``W._precision``)."""
    mp = pytest.MonkeyPatch()
    with W._precision(mp, True):
        out = port(flat, torch.float64)
    mp.undo()
    return out


JD = JaxDiT(dtype=jnp.float32, **KW)


@jax.jit
def _jax_fp32(p):
    def loss(p):
        logits = JD.apply(p, *BATCH)
        return jnp.sum(logits * WEIGHTS.astype(np.float32)), logits

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(p)
    return logits, grads


def jax_fp32(flat):
    logits, grads = _jax_fp32(unflatten({k: jnp.asarray(v) for k, v in flat.items()}))
    out = {k.removeprefix("params/"): np.asarray(v, np.float64)
           for k, v in flatten(grads).items()}
    out["logits"] = np.asarray(logits, np.float64)
    return out


def err(got, ref):
    """(largest error × 1 / max(1, max |ref|), where)."""
    return max((float(np.abs(got[k] - r).max() / max(1.0, np.abs(r).max())), k)
               for k, r in ref.items())


def f64_scores(which):
    """The plain version with the scores of call ``which`` (or every call)
    in float64, rounded once to fp32."""
    orig, n = train_ops.train_flash_attention_plain, [0]

    def plain(q, k, v, kv_mask, causal=False):
        i, n[0] = n[0], n[0] + 1
        if which != "all" and i != which:
            return orig(q, k, v, kv_mask, causal)
        s = torch.einsum("bihd,bjhd->bhij", q.double(), k.double()) * q.shape[-1] ** -0.5
        s = torch.where(train_ops.visible(kv_mask, q.shape[1], causal), s.float(),
                        train_ops.NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhij,bjhd->bihd", p.to(v.dtype).float(), v.float()).to(v.dtype)

    return plain


def main():
    init = jax.jit(JaxDiT(dtype=jnp.float32, **KW).init)(jax.random.PRNGKey(0), *W._dit_batch())
    flat = perturbed(init, seed=1)
    ref = reference(flat)
    print("1. seeded weights: jax fp32 %.3g (%s), port fp32 %.3g (%s)"
          % (*err(jax_fp32(flat), ref), *err(port(flat, torch.float32), ref)))
    rs = np.random.RandomState(0)
    j, p = [], []
    for _ in range(10):
        moved = {k: (v * (1 + 2.0 ** -23 * rs.randint(-1, 2, v.shape))).astype(np.float32)
                 for k, v in flat.items()}
        r = reference(moved)
        j.append(err(jax_fp32(moved), r)[0])
        p.append(err(port(moved, torch.float32), r)[0])
    print("2. one-ulp draws: jax fp32 %.3g to %.3g (median %.3g), port fp32 %.3g to %.3g "
          "(median %.3g)" % (min(j), max(j), np.median(j), min(p), max(p), np.median(p)))
    for which in (PROMPT_LAYER_0, "all"):
        print("3. float64 scores at call %s: port fp32 %.3g (%s)"
              % (which, *err(port(flat, torch.float32, f64_scores(which)), ref)))
    print("   at flax's init weights: jax fp32 %.3g, port fp32 %.3g"
          % (err(jax_fp32(flatten(init)), reference(flatten(init)))[0],
             err(port(flatten(init), torch.float32), reference(flatten(init)))[0]))


if __name__ == "__main__":
    main()
