"""Load the reference PyTorch implementation and convert its weights
(counterpart of ``compat/reference.py`` in the JAX package, whose code this
copies).

The reference (csulb-datascience/TTS-with-Diffusion-model, checked out at
``DEFAULT_REFERENCE_ROOT``) is pure PyTorch with CUDA hard-coded in the
diffusion variants (``vall_e/vall_e/ar_discrete.py:269-277,652``) and two
dependencies it imports without needing them (``diffusers``, ``timm``: only
``timm.Mlp`` is exercised).  This module makes the reference importable on
the CPU:

  - ``install_dependency_stubs()`` registers a faithful ``timm`` ``Mlp``
    (fc1 → act → drop → fc2 → drop, the layout timm documents) and inert
    ``diffusers`` placeholders;
  - ``load_reference()`` imports ``vall_e.vall_e.{base,ar,nar}`` directly
    and ``ar_discrete`` through a source-patching loader that rewrites the
    hard-coded ``"cuda"`` device strings to ``"cpu"``;

and converts reference ``state_dict``s into the converted-weights layout
(nested dicts of numpy arrays under flax names, which
``convert.jax_params_to_torch`` loads into the port's models and the JAX
package loads as they are):

  - ``base_params_from_torch``  → the ``Base`` trunk of the AR and NAR;
  - ``dit_params_from_torch``   → the DiT denoiser at its reference-parity
    configuration.

Conventions: torch ``Linear.weight`` is (out, in) → flax ``kernel`` is its
transpose; torch ``MultiheadAttention`` packs q/k/v into ``in_proj_weight``
rows → split into separate q/k/v kernels.  The reference's ``DiTBlock``
applies ``cross_attn`` to *both* conditioning streams
(``ar_discrete.py:142``), leaving ``cross_attn2`` as dead parameters — the
converter mirrors that by copying ``cross_attn`` into both cross-attentions,
so converted checkpoints reproduce reference outputs exactly.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import os
import sys
import types
from types import SimpleNamespace

import numpy as np

DEFAULT_REFERENCE_ROOT = "/root/reference"

_ref_cache: dict[str, SimpleNamespace] = {}


# ---------------------------------------------------------------- stubs


def _stub_module(name: str) -> types.ModuleType:
    """A ``sys.modules`` stand-in with a real ``ModuleSpec``.

    A bare ``types.ModuleType`` has ``__spec__ = None``, which makes
    ``importlib.util.find_spec(name)`` *raise* ``ValueError`` instead of
    answering — and ``transformers`` probes ``find_spec("timm")`` at import
    time, so a spec-less stub poisons any later ``import transformers`` in
    the same process.  Stubs must be honest citizens of the import system.
    """
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, loader=None)
    if "." not in name:  # top-level stubs act as namespace-ish packages
        mod.__spec__.submodule_search_locations = []
        mod.__path__ = []
    return mod


def install_dependency_stubs() -> None:
    """Register import-time stand-ins for deps the reference imports.

    Only ``timm``'s ``Mlp`` carries real computation in the reference's
    live code paths; everything else is import-only surface.
    """
    import torch.nn as nn

    if "timm" not in sys.modules:

        class Mlp(nn.Module):
            """timm's two-layer MLP, as documented: fc1/act/drop1/fc2/drop2."""

            def __init__(
                self,
                in_features,
                hidden_features=None,
                out_features=None,
                act_layer=nn.GELU,
                norm_layer=None,
                bias=True,
                drop=0.0,
                use_conv=False,
            ):
                super().__init__()
                out_features = out_features or in_features
                hidden_features = hidden_features or in_features
                self.fc1 = nn.Linear(in_features, hidden_features, bias=bias)
                self.act = act_layer()
                self.drop1 = nn.Dropout(drop)
                self.norm = (
                    norm_layer(hidden_features) if norm_layer else nn.Identity()
                )
                self.fc2 = nn.Linear(hidden_features, out_features, bias=bias)
                self.drop2 = nn.Dropout(drop)

            def forward(self, x):
                return self.drop2(self.fc2(self.norm(self.drop1(self.act(self.fc1(x))))))

        timm = _stub_module("timm")
        timm_models = _stub_module("timm.models")
        timm_vt = _stub_module("timm.models.vision_transformer")
        timm_vt.Mlp = Mlp
        timm_vt.PatchEmbed = type("PatchEmbed", (), {})
        timm_vt.Attention = type("Attention", (), {})
        timm.models = timm_models
        timm_models.vision_transformer = timm_vt
        sys.modules["timm"] = timm
        sys.modules["timm.models"] = timm_models
        sys.modules["timm.models.vision_transformer"] = timm_vt

    if "diffusers" not in sys.modules:
        diffusers = _stub_module("diffusers")
        for name in (
            "UNet3DConditionModel",
            "UNet2DConditionModel",
            "DDPMScheduler",
            "CosineDPMSolverMultistepScheduler",
            "DDIMScheduler",
        ):
            setattr(diffusers, name, type(name, (), {}))
        sys.modules["diffusers"] = diffusers


def _load_patched_module(fullname: str, path: str) -> types.ModuleType:
    """Import a reference source file with its CUDA device strings rewritten
    to CPU (the only edit needed to run the diffusion variants off-GPU)."""
    with open(path) as f:
        src = f.read()
    src = src.replace('"cuda:0"', '"cpu"').replace("'cuda:0'", "'cpu'")
    src = src.replace('"cuda"', '"cpu"').replace("'cuda'", "'cpu'")
    spec = importlib.util.spec_from_file_location(fullname, path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = fullname.rsplit(".", 1)[0]
    sys.modules[fullname] = mod
    code = compile(src, path, "exec")
    exec(code, mod.__dict__)
    return mod


def load_reference(root: str = DEFAULT_REFERENCE_ROOT) -> SimpleNamespace:
    """Import the reference's model modules on CPU.

    The package ``__init__``s are *not* executed: ``vall_e/config.py`` runs
    ``Config.from_cli()`` at import time (``config.py:96``), consuming
    ``sys.argv`` and importing ``diskcache`` — both unwanted side effects
    under a test runner.  Synthetic parent packages with the right
    ``__path__`` are registered instead, so the model modules' relative
    imports (``from .base import Base``) resolve without touching config.

    Returns a namespace with ``base``, ``ar``, ``nar``, ``ar_discrete``
    (the D3PM variant, CUDA-patched).
    """
    if root in _ref_cache:
        return _ref_cache[root]
    install_dependency_stubs()
    for name, path in (
        ("vall_e", os.path.join(root, "vall_e")),
        ("vall_e.vall_e", os.path.join(root, "vall_e", "vall_e")),
    ):
        if name not in sys.modules:
            pkg = types.ModuleType(name)
            pkg.__path__ = [path]
            pkg.__package__ = name
            sys.modules[name] = pkg
    base = importlib.import_module("vall_e.vall_e.base")
    ar = importlib.import_module("vall_e.vall_e.ar")
    nar = importlib.import_module("vall_e.vall_e.nar")
    ar_discrete = _load_patched_module(
        "vall_e.vall_e.ar_discrete",
        os.path.join(root, "vall_e", "vall_e", "ar_discrete.py"),
    )
    ns = SimpleNamespace(base=base, ar=ar, nar=nar, ar_discrete=ar_discrete)
    _ref_cache[root] = ns
    return ns


def reference_d3pm(
    ref: SimpleNamespace | None = None,
    *,
    cache_path: str | None = None,
    seed: int = 0,
):
    """Construct the reference D3PM ``ar_discrete.AR(512, 100, 1024, 8, 8, 6)``
    on CPU, optionally disk-caching its fp16 transition matrices.

    The reference ``__init__`` cumulates 99 fp16 ``tensordot`` products of
    1025×1025 matrices (``ar_discrete.py:268-277``) — minutes of wall time on
    a CPU host because torch's fp16 CPU matmul takes a slow path.  The
    matrices are deterministic (no RNG involved), so with ``cache_path`` set
    they are computed once and stored compressed (absorbing-state transition
    matrices are diagonal-plus-one-column, so they compress to ~nothing);
    later constructions stub out ``torch.tensordot`` during ``__init__`` and
    restore the exact cached fp16 values.  Pass ``cache_path=None`` (or
    delete the file) to force the full recomputation.

    Weights are initialized under ``torch.manual_seed(seed)`` either way
    (matrix construction consumes no RNG, so cached and uncached builds have
    identical parameters).
    """
    import torch

    if ref is None:
        ref = load_reference()

    cached = None
    if cache_path is not None and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            cached = {k: z[k] for k in ("betas", "q_onestep_mats", "q_mats")}

    torch.manual_seed(seed)
    if cached is not None:
        real_tensordot = torch.tensordot
        torch.tensordot = lambda a, b, dims: a  # skip the O(T·K³) fp16 loop
        try:
            model = ref.ar_discrete.AR(512, 100, 1024, 8, 8, 6).eval()
        finally:
            torch.tensordot = real_tensordot
        model.betas = torch.from_numpy(cached["betas"])
        model.q_onestep_mats = torch.from_numpy(cached["q_onestep_mats"])
        model.q_mats = torch.from_numpy(cached["q_mats"])
        model.transpose_q_onestep_mats = torch.transpose(
            model.q_onestep_mats, 1, 2
        )
    else:
        model = ref.ar_discrete.AR(512, 100, 1024, 8, 8, 6).eval()
        if cache_path is not None:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            np.savez_compressed(
                cache_path,
                betas=model.betas.numpy(),
                q_onestep_mats=model.q_onestep_mats.numpy(),
                q_mats=model.q_mats.numpy(),
            )
    return model


# ---------------------------------------------------------------- converters


def _t2n(t) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _linear(sd: dict, prefix: str) -> dict:
    out = {"kernel": _t2n(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t2n(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd: dict, prefix: str) -> dict:
    return {
        "scale": _t2n(sd[f"{prefix}.weight"]),
        "bias": _t2n(sd[f"{prefix}.bias"]),
    }


def _mha(sd: dict, prefix: str) -> dict:
    """torch ``nn.MultiheadAttention`` → the DiT's ``MHA`` (split q/k/v)."""
    w = _t2n(sd[f"{prefix}.in_proj_weight"])
    b = _t2n(sd[f"{prefix}.in_proj_bias"])
    d = w.shape[1]
    return {
        "q": {"kernel": w[:d].T, "bias": b[:d]},
        "k": {"kernel": w[d : 2 * d].T, "bias": b[d : 2 * d]},
        "v": {"kernel": w[2 * d :].T, "bias": b[2 * d :]},
        "out": _linear(sd, f"{prefix}.out_proj"),
    }


def base_params_from_torch(
    sd: dict, n_layers: int, norm_type: str = "ln"
) -> dict:
    """Reference ``Base`` state_dict → the ``Base`` trunk's parameters.

    Wrap as ``{"params": {"base": <result>}}`` for the AR/NAR modules
    (their single submodule is named ``base``).
    """

    def norm(prefix: str) -> dict:
        if norm_type == "adaln":
            return {"emb": _t2n(sd[f"{prefix}.emb.weight"])}
        return _layernorm(sd, prefix)

    out = {
        "text_emb": {"embedding": _t2n(sd["text_emb.weight"])},
        "proms_emb": {"weight": _t2n(sd["proms_emb.weight"])},
        "resps_emb": {"weight": _t2n(sd["resps_emb.weight"])},
        "sep": _t2n(sd["sep"]),
        "classifier": _linear(sd, "classifier"),
    }
    for i in range(n_layers):
        p = f"blocks.{i}"
        out[f"block_{i}"] = {
            "norm_attn": norm(f"{p}.attn.norm"),
            "norm_ffn": norm(f"{p}.ffn.norm"),
            "attn": {
                "to_qkv": {"kernel": _t2n(sd[f"{p}.attn.block.to_qkv.weight"]).T},
                "to_out": _linear(sd, f"{p}.attn.block.to_out"),
            },
            "ffn": {
                "fc1": _linear(sd, f"{p}.ffn.block.0"),
                "fc2": _linear(sd, f"{p}.ffn.block.3"),
            },
        }
    return out


def _encoder_layer(sd: dict, prefix: str) -> dict:
    """torch ``TransformerEncoderLayer`` (post-norm) → the DiT's ``EncoderLayer``."""
    return {
        "self_attn": _mha(sd, f"{prefix}.self_attn"),
        "norm1": _layernorm(sd, f"{prefix}.norm1"),
        "norm2": _layernorm(sd, f"{prefix}.norm2"),
        "ffn": {
            "fc1": _linear(sd, f"{prefix}.linear1"),
            "fc2": _linear(sd, f"{prefix}.linear2"),
        },
    }


def _cond_tower(sd: dict, prefix: str, n_layers: int = 2) -> dict:
    """Reference tower ``Sequential(TransformerEncoder, Mlp)``
    (``ar_discrete.py:216-230``) → the DiT's ``CondTower``."""
    out = {
        f"layer_{i}": _encoder_layer(sd, f"{prefix}.0.layers.{i}")
        for i in range(n_layers)
    }
    out["mlp"] = {
        "fc1": _linear(sd, f"{prefix}.1.fc1"),
        "fc2": _linear(sd, f"{prefix}.1.fc2"),
    }
    return out


def _dit_block(sd: dict, prefix: str) -> dict:
    cross = _mha(sd, f"{prefix}.cross_attn")
    return {
        "norm1": _layernorm(sd, f"{prefix}.norm1"),
        "attn": _mha(sd, f"{prefix}.attn"),
        "norm2": _layernorm(sd, f"{prefix}.norm2"),
        "cross_attn": cross,
        "norm22": _layernorm(sd, f"{prefix}.norm22"),
        # The reference applies cross_attn to the speaker stream too
        # (``ar_discrete.py:142``); cross_attn2's own weights are dead.
        "cross_attn2": cross,
        "norm3": _layernorm(sd, f"{prefix}.norm3"),
        "mlp": {
            "fc1": _linear(sd, f"{prefix}.mlp.fc1"),
            "fc2": _linear(sd, f"{prefix}.mlp.fc2"),
        },
        "timestep_fc": _linear(sd, f"{prefix}.timestep_fc"),
    }


def dit_params_from_torch(sd: dict, n_layers: int = 8) -> dict:
    """Reference D3PM denoiser state_dict (``ar_discrete.AR``) → the
    ``DiTDenoiser``'s parameters (wrap as ``{"params": <result>}``).

    The target denoiser must be built at the reference-parity
    configuration: ``tower_ffn_dim=2048, tower_act="relu"``
    (``TransformerEncoderLayer`` defaults) and ``resp_pe=False`` (the
    reference adds no positional encoding to the noisy response).
    """
    out = {
        "text_emb": {"embedding": _t2n(sd["text_emb.weight"])},
        "proms_emb": {"weight": _t2n(sd["proms_emb.weight"])},
        "resps_emb": {"embedding": _t2n(sd["resps_emb.weight"])},
        "time_emb": {"embedding": _t2n(sd["time_emb.weight"])},
        "text_tower": _cond_tower(sd, "encodertext"),
        "prom_tower": _cond_tower(sd, "encoder2"),
        "final": _linear(sd, "final"),
    }
    for i in range(n_layers):
        out[f"dit_{i}"] = _dit_block(sd, f"blocks.{i}")
    return out
