"""Inference precision (counterpart of ``utils/precision.py`` in the JAX
package).

``cast_params_bf16``: weight matrices and embeddings to bf16 for serving
(activations already run in bf16; halving the parameter bytes roughly halves
the bandwidth-bound per-token decode cost).  Norm, scale and bias parameters
and anything 1-D stay fp32: they are tiny and precision-sensitive.  Training
keeps fp32 masters.
"""

from __future__ import annotations

import torch


def cast_params_bf16(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter of two or more dimensions becomes bf16, except under
    a norm; biases, norms and other 1-D parameters stay fp32.  In place;
    returns ``module``."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2 and "norm" not in name.lower():
                p.data = p.data.to(torch.bfloat16)
    return module
