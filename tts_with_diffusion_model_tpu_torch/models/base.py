"""Shared backbone pieces (counterpart of ``models/base.py`` in the JAX
package), and the flax-equivalent layers the port's models are built from.

The packed slot layout ``[ text (Tt) | sep | proms (Tp) | sep | resps (Tr) ]``
with per-segment masks and packed positions ``cumsum(mask) - 1`` is kept as
it is.  ``Base`` is the JAX constructor's trunk (causal or not, ``ln`` or
``adaln`` norms, an optional stop token, dropout, per-block remat) in batch
mode, and the AR's KV-cache paths (``prefill``, ``decode_step``,
``decode_chunk``) over a ``KVCache`` written in place.

Dtypes follow flax's promotion so the port serves in the JAX package's
precision: a ``Dense`` with a compute ``dtype`` casts input, weight and bias
to it (bf16 in serving, fp32 for the logits heads); ``LayerNorm`` computes in
fp32 and returns fp32 (its scale and bias stay fp32); embedding lookups keep
the table's dtype.

Dropout draws from explicit generators, never torch's default one: the
forward takes the step's generator, draws one seed per block from it, and
each block builds its masks from a fresh generator seeded with its seed.  A
block recomputed under ``torch.utils.checkpoint`` therefore redraws the
masks it drew the first time (checkpoint restores only the default
generators' states).

Tensor parallelism: each layer that splits declares it, as the flax
modules tag their logical axes.  ``tp_plan(tp)`` names the dimension of
each of its parameters tagged ``heads`` / ``mlp`` / ``vocab`` (none where tp
does not divide it), and ``tp_shard(axis)`` (``parallel/mesh.shard_module``)
switches it to its tensor-parallel forward: the attention's projections and
the MLP's ``fc1`` become column-parallel (output features split), their
out-projection and ``fc2`` row-parallel (input features split, the partial
products summed over the tp row), a vocab head gathers its logits, and an
``Embed`` / ``MultiEmbedding`` holds a block of the vocabulary, looks up the
ids inside it and sums over the row.  A dropout mask is drawn for the
global batch (``rows``: a dp step's ``parallel.comm.Rows``) and the full
width and cut to the rank's rows and columns, so neither dp nor tp changes
it.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from ..ops import route
from ..ops.attention import dense_attention
from ..parallel.comm import copy_to, draw_global, gather_from, global_sum, reduce_from
from ..parallel.mesh import Split


class Dense(nn.Module):
    """``flax.linen.Dense``: weight (out, in) (the flax kernel transposed).
    ``vocab`` tags the output features ``vocab`` (a logits head: under tp
    its rows split and its logits are gathered).  ``tp``: None, or (mode, tp
    axis) with mode "col" (output features split), "row" (input features
    split; the bias is added after the sum) or "gather" (a column-parallel
    head whose outputs are gathered)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, dtype=None,
                 vocab: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.dtype, self.vocab = dtype, vocab
        self.tp = None

    def tp_plan(self, tp: int) -> dict[str, Split]:
        if not self.vocab or self.weight.shape[0] % tp:
            return {}
        return {n: Split(0, "vocab") for n in ("weight", "bias") if getattr(self, n) is not None}

    def tp_shard(self, axis):
        self.tp = ("gather", axis)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = self.bias.to(dt) if self.bias is not None else None
        if self.tp is None:
            return F.linear(x.to(dt), self.weight.to(dt), b)
        mode, axis = self.tp
        if mode == "row":
            y = reduce_from(F.linear(x.to(dt), self.weight.to(dt)), axis)
            return y if b is None else y + b
        y = F.linear(copy_to(x, axis).to(dt), self.weight.to(dt), b)
        return gather_from(y, axis) if mode == "gather" else y


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: statistics and output in fp32."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps)


def _vocab_lookup(table, ids, axis, index=()):
    """``table[*index, ids]`` when the table holds the tp axis's block of
    the vocabulary (dimension ``len(index)``): each rank looks up the ids
    inside its block, zero elsewhere, and the row sums (exact: one rank
    contributes each value)."""
    n = table.shape[len(index)]
    local = ids - axis.rank * n
    hit = (local >= 0) & (local < n)
    out = table[(*index, local.clamp(0, n - 1))] * hit[..., None].to(table.dtype)
    return reduce_from(out, axis)


class Embed(nn.Module):
    """``flax.linen.Embed``: a table lookup in the table's dtype.  ``vocab``
    tags the table's rows ``vocab``; ``tp``: the axis they split over, or
    None."""

    def __init__(self, n: int, d: int, vocab: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, d))
        self.vocab = vocab
        self.tp = None

    def tp_plan(self, tp: int) -> dict[str, Split]:
        return {"weight": Split(0, "vocab")} if self.vocab and not self.weight.shape[0] % tp else {}

    def tp_shard(self, axis):
        self.tp = axis

    def forward(self, ids):
        if self.tp is None:
            return self.weight[ids]
        return _vocab_lookup(self.weight, ids, self.tp)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax ``padding="SAME"`` for one spatial dim: the output has
    ceil(size / stride) positions, and the padding's odd unit goes after
    (a stride-2 k3 conv over an even length pads (0, 1), not (1, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``flax.linen.Conv`` over channel-last input (B, *spatial, Cin) with
    ``padding="SAME"``: weight (Cout, Cin, *kernel) (the
    flax kernel (*kernel, Cin, Cout) moved), 1-D or 2-D; a compute ``dtype``
    casts input, weight and bias as ``Dense`` does."""

    def __init__(self, d_in: int, d_out: int, kernel: tuple, strides: tuple | None = None,
                 dtype=None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides) if strides is not None else (1,) * len(self.kernel)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(d_out, d_in, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        nd = len(self.kernel)
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        h = x.to(dt).movedim(-1, 1)
        pads = [same_padding(n, k, s) for n, k, s in zip(h.shape[2:], self.kernel, self.strides)]
        h = F.pad(h, [p for lo_hi in reversed(pads) for p in lo_hi])
        conv = F.conv1d if nd == 1 else F.conv2d
        y = conv(h, self.weight.to(dt), self.bias.to(dt), stride=self.strides)
        return y.movedim(1, -1)


class ConvTranspose(nn.Module):
    """``flax.linen.ConvTranspose`` (1-D, ``padding="SAME"``, flax's default
    ``transpose_kernel=False``) over channel-last input (B, T, Cin): the
    output has T·stride positions.  flax correlates the stride-dilated input
    with its kernel unflipped; torch's transposed convolution scatters
    with its kernel, so the weight (Cin, Cout, K) is the flax kernel
    (K, Cin, Cout) moved *and flipped along K*.  The padded dilated input
    of flax starts ``K − 1 − pad_lo`` positions into torch's unpadded
    output."""

    def __init__(self, d_in: int, d_out: int, kernel: int, stride: int, dtype=None):
        super().__init__()
        self.k, self.stride, self.dtype = int(kernel), int(stride), dtype
        self.weight = nn.Parameter(torch.zeros(d_in, d_out, self.k))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        k, s = self.k, self.stride
        # lax.conv_transpose's "SAME" padding of the dilated input
        pad_lo = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
        T = x.shape[1]
        y = F.conv_transpose1d(x.to(dt).movedim(-1, 1), self.weight.to(dt), stride=s)
        start = k - 1 - pad_lo
        y = y[..., start: start + T * s]
        if y.shape[-1] < T * s:
            y = F.pad(y, (0, T * s - y.shape[-1]))
        return (y + self.bias.to(dt)[:, None]).movedim(1, -1)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` over channel-last input (B, *spatial, C):
    per (batch, group) statistics over every position and the group's
    channels, in fp32 with fp32 output; scale and bias fp32.  The variance
    is flax's one-pass max(0, E[x²] − E[x]²): groups of a few elements
    (the UNet's bottom level at a short bucket) amplify the difference to
    a two-pass variance."""

    def __init__(self, num_groups: int, d: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        xg = x.float().reshape(B, -1, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return y * self.weight.float() + self.bias.float()


def gelu(x):
    """erf-form GELU (flax ``gelu(approximate=False)`` ≡ torch ``nn.GELU``)."""
    return F.gelu(x, approximate="none")


def sinusoidal_embedding(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """``[sin(ω_i·x) ‖ cos(ω_i·x)]`` with ``ω_i = exp(-ln(1e4)·i/(d/2))``, fp32."""
    d_half = d_model // 2
    exponent = torch.arange(d_half, dtype=torch.float32, device=pos.device) / d_half
    omega = torch.exp(-math.log(1e4) * exponent)
    x = pos.float()[..., None] * omega
    return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


class MultiEmbedding(nn.Module):
    """Sum of per-RVQ-level embeddings.  tokens (..., T, L) → (..., T, D);
    ``level_mask`` (..., L) selects the levels that contribute.  The tokens
    are tagged ``vocab``; ``tp``: the axis they split over, or None."""

    def __init__(self, max_n_levels: int, n_tokens: int, token_dim: int):
        super().__init__()
        self.max_n_levels = max_n_levels
        self.weight = nn.Parameter(torch.zeros(max_n_levels, n_tokens, token_dim))
        self.tp = None

    def tp_plan(self, tp: int) -> dict[str, Split]:
        return {} if self.weight.shape[1] % tp else {"weight": Split(1, "vocab")}

    def tp_shard(self, axis):
        self.tp = axis

    def forward(self, tokens, level_mask=None):
        lvl = torch.arange(self.max_n_levels, device=tokens.device)
        if self.tp is None:
            emb = self.weight[lvl, tokens]  # (..., T, L, D)
        else:  # summed over tp before the levels: the same values as 1x1
            emb = _vocab_lookup(self.weight, tokens, self.tp, (lvl,))
        if level_mask is not None:
            while level_mask.ndim < emb.ndim - 1:
                level_mask = level_mask[..., None, :]
            emb = emb * level_mask[..., None].to(emb.dtype)
        return emb.sum(dim=-2)


def _layer_norm(x, eps: float = 1e-5):
    """Parameter-free LN computed in fp32, returned in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


class AdaLN(nn.Module):
    """Level-conditioned norm with the AdaNorm trick ``c·(1 − k·h)·h`` (the
    ``h`` inside the bracket is a constant under autodiff, as in the JAX
    package)."""

    def __init__(self, d_model: int, n_levels: int, eps: float = 1e-5,
                 k: float = 0.1, c: float = 2.0):
        super().__init__()
        self.emb = nn.Parameter(torch.zeros(n_levels, 2 * d_model))
        self.eps, self.k, self.c = eps, k, c

    def forward(self, x, level):
        params = self.emb[level]  # (B, 2D)
        log_gamma, beta = params[:, None, :].chunk(2, dim=-1)
        h = _layer_norm(x, self.eps)
        h = self.c * (1 - (self.k * h).detach()) * h
        return (torch.exp(log_gamma) * h + beta).to(x.dtype)


#: matmuls without batch dims (every Dense projection) and batched ones
#: (attention scores and values on the plain path)
_MATMULS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})
_BATCHED_MATMULS = frozenset({torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default})
_REMAT_SAVED = {"dots": _MATMULS, "dots_all": _MATMULS | _BATCHED_MATMULS}


def resolve_remat_policy(name: str | None):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a config string
    (the JAX package's ``jax.checkpoint_policies``): ``None`` and
    ``"nothing"`` → whole-block recompute; ``"dots"`` saves every matmul
    without batch dims (the Dense projections: ``aten.mm`` / ``aten.addmm``)
    and recomputes the rest, attention included, which is the O(T²) memory
    remat exists to shed; ``"dots_all"`` also saves the batched matmuls.
    Gradients are the same under every policy; only the recompute / memory
    trade moves.  The attention kernels run in the recompute whatever the
    policy: they are no matmul op."""
    if name is None or name == "nothing":
        return noop_context_fn
    if name not in _REMAT_SAVED:
        raise ValueError(f"unknown remat policy {name!r}; one of "
                         f"{sorted([*_REMAT_SAVED, 'nothing'])}")
    saved = _REMAT_SAVED[name]

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


class Dropout:
    """Inverted dropout at rate ``p`` from one block's seed (flax
    ``nn.Dropout``: keep with probability 1 − p, scale kept values by
    1 / (1 − p)).  Each call draws the next mask from the block's own
    generator, so the block's sites take masks in a fixed order.  The mask
    is drawn for the global batch (a dp step) and, for an activation whose
    features split over ``tp`` (an axis), for the full width, and cut to
    this rank's rows and features."""

    def __init__(self, p: float, seed: int, device, rows=None):
        self.keep = 1.0 - p
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.rows = rows

    def __call__(self, x, tp=None):
        n = x.shape[-1]
        width = n if tp is None else n * tp.size

        def draw(rows):
            return torch.rand((rows, *x.shape[1:-1], width), generator=self.generator,
                              device=x.device)

        u = draw_global(draw, x.shape[0], self.rows)
        if tp is not None:
            u = u[..., tp.rank * n:(tp.rank + 1) * n]
        return torch.where(u < self.keep, x / self.keep, torch.zeros((), dtype=x.dtype,
                                                                     device=x.device))


def _no_dropout(x, tp=None):
    return x


class Attention(nn.Module):
    """Multi-head self-attention over packed slots, batch mode, through
    ``ops/route.attend``: keys are masked by the kernel (and, with
    ``causal``, hidden past the query's slot); padding query rows are zeroed
    by ``to_out(o) * mask``.  q, k and v are read in place from the fused
    ``to_qkv`` output.  ``decode`` is the cached path."""

    def __init__(self, d_model: int, n_heads: int, causal: bool = False, dtype=None):
        super().__init__()
        self.d_model, self.n_heads, self.causal = d_model, n_heads, causal
        self.to_qkv = Dense(d_model, 3 * d_model, bias=False, dtype=dtype)
        self.to_out = Dense(d_model, d_model, dtype=dtype)

    def tp_plan(self, tp: int) -> dict[str, Split]:
        """to_qkv (EMBED, HEADS) of width 3·d: each rank its heads of q, of
        k and of v; to_out (HEADS, EMBED) row-parallel."""
        if self.n_heads % tp:
            return {}
        return {"to_qkv.weight": Split(0, "heads", 3), "to_out.weight": Split(1, "heads")}

    def tp_shard(self, axis):
        self.n_heads //= axis.size
        self.d_model //= axis.size
        self.to_qkv.tp, self.to_out.tp = ("col", axis), ("row", axis)

    def _qkv(self, x):
        B, T, _ = x.shape
        return self.to_qkv(x).view(B, T, 3, self.n_heads, self.d_model // self.n_heads)

    def forward(self, x, mask, return_kv: bool = False):
        B, T, _ = x.shape
        qkv = self._qkv(x)
        o = route.attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask, causal=self.causal)
        o = self.to_out(o.reshape(B, T, self.d_model)) * mask[..., None].to(x.dtype)
        return (o, (qkv[:, :, 1], qkv[:, :, 2])) if return_kv else o

    def decode(self, x, cache_k, cache_v, index: int, kv_mask):
        """Cached decode of W tokens (W = 1: a decode step; W > 1: the
        speculative verify chunk).  x: (B, W, D); their k, v are written at
        slots ``index .. index + W - 1`` of ``cache_{k,v}`` (B, Tc, H, Dh) in
        place; ``kv_mask`` (B, Tc) marks the valid slots, the W new ones
        included.  Query j sees the valid slots ``<= index + j``.  Only
        ``cache[:, :index + W]`` is read: every later slot is masked, and a
        masked score's ``exp(NEG_INF - max)`` is exactly 0."""
        B, W, _ = x.shape
        qkv = self._qkv(x)
        n = index + W
        cache_k[:, index:n] = qkv[:, :, 1]
        cache_v[:, index:n] = qkv[:, :, 2]
        pair = kv_mask[:, None, :n]
        if W > 1:
            slot = torch.arange(n, device=x.device)
            pair = pair * (slot[None, :] <= index + torch.arange(W, device=x.device)[:, None])
        o = dense_attention(qkv[:, :, 0], cache_k[:, :n], cache_v[:, :n], pair_mask=pair)
        return self.to_out(o.reshape(B, W, self.d_model))


class TensorParallelMlp:
    """The tp split of an ``fc1`` → ``fc2`` MLP: the hidden width is tagged
    ``mlp``, ``fc1`` column-parallel and ``fc2`` row-parallel."""

    def tp_plan(self, tp: int) -> dict[str, Split]:
        if self.fc1.weight.shape[0] % tp:
            return {}
        plan = {"fc1.weight": Split(0, "mlp"), "fc2.weight": Split(1, "mlp")}
        if self.fc1.bias is not None:
            plan["fc1.bias"] = Split(0, "mlp")
        return plan

    def tp_shard(self, axis):
        self.fc1.tp, self.fc2.tp = ("col", axis), ("row", axis)


class FeedForward(TensorParallelMlp, nn.Module):
    def __init__(self, d_model: int, dtype=None):
        super().__init__()
        self.fc1 = Dense(d_model, 4 * d_model, dtype=dtype)
        self.fc2 = Dense(4 * d_model, d_model, dtype=dtype)

    def forward(self, x, drop=_no_dropout):
        tp = self.fc1.tp[1] if self.fc1.tp is not None else None
        return self.fc2(drop(gelu(self.fc1(x)), tp))


class PrenormBlock(nn.Module):
    """Pre-norm attention + FFN residual block, with ``ln`` (LayerNorm, eps
    1e-5, the AR's) or ``adaln`` (level-conditioned, the NAR's) norms and
    dropout after the attention, inside the FFN and after it."""

    def __init__(self, d_model: int, n_heads: int, p_dropout: float = 0.0,
                 causal: bool = False, norm_type: str = "ln", n_levels: int | None = None,
                 dtype=None):
        super().__init__()
        if norm_type == "adaln":
            if n_levels is None:
                raise ValueError("adaln needs n_levels")
            self.norm_attn = AdaLN(d_model, n_levels)
            self.norm_ffn = AdaLN(d_model, n_levels)
        elif norm_type == "ln":
            self.norm_attn = LayerNorm(d_model, eps=1e-5)
            self.norm_ffn = LayerNorm(d_model, eps=1e-5)
        else:
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.norm_type, self.p_dropout = norm_type, p_dropout
        self.attn = Attention(d_model, n_heads, causal, dtype=dtype)
        self.ffn = FeedForward(d_model, dtype=dtype)

    def _norm(self, norm, x, level):
        return norm(x, level) if self.norm_type == "adaln" else norm(x)

    def forward(self, x, mask, level, seed: int | None = None, rows=None):
        """``seed`` turns dropout on (None: deterministic); ``rows``: a dp
        step's rows, whose masks are cut from the global batch's."""
        drop = _no_dropout
        if seed is not None and self.p_dropout > 0:
            drop = Dropout(self.p_dropout, seed, x.device, rows)
        m = mask[..., None].to(x.dtype)
        h = drop(self.attn(self._norm(self.norm_attn, x, level) * m, mask))
        x = (x + h) * m
        h = drop(self.ffn(self._norm(self.norm_ffn, x, level) * m, drop))
        return (x + h) * m

    def prefill(self, x, mask, level):
        """Deterministic batch forward that also returns this block's (k, v)
        (B, T, H, Dh) for the cache."""
        m = mask[..., None].to(x.dtype)
        h, kv = self.attn(self._norm(self.norm_attn, x, level) * m, mask, return_kv=True)
        x = (x + h) * m
        return (x + self.ffn(self._norm(self.norm_ffn, x, level) * m)) * m, kv

    def decode(self, x, cache_k, cache_v, index: int, kv_mask, level):
        """Cached decode of x (B, W, D): no mask multiply, as in the JAX
        package's ``decode_step`` / ``decode_chunk``."""
        x = x + self.attn.decode(self._norm(self.norm_attn, x, level), cache_k, cache_v,
                                 index, kv_mask)
        return x + self.ffn(self._norm(self.norm_ffn, x, level))


def packed_layout(text_mask, prom_mask, resp_mask):
    """Merged mask / packed positions / segment ids, each (B, Tt+1+Tp+1+Tr);
    segment ids: 0=text, 1=sep, 2=prom, 3=sep2, 4=resp."""
    B = text_mask.shape[0]
    one = text_mask.new_ones((B, 1))
    mask = torch.cat([text_mask, one, prom_mask, one, resp_mask], dim=1)
    pos = torch.cumsum(mask, dim=1) - 1
    seg = torch.cat([
        torch.full_like(text_mask, 0), torch.full_like(one, 1),
        torch.full_like(prom_mask, 2), torch.full_like(one, 3),
        torch.full_like(resp_mask, 4),
    ], dim=1)
    return mask, pos, seg


class Base(nn.Module):
    """The shared trunk: embeds the three segments, runs ``n_layers`` blocks,
    projects to ``n_resp_tokens`` logits (``n_tokens``, plus the stop token
    with ``use_stop_token``).  Defaults are the JAX constructor's."""

    def __init__(self, n_tokens: int, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 12, p_dropout: float = 0.1, causal: bool = False,
                 n_resp_levels: int = 1, use_stop_token: bool = False, norm_type: str = "ln",
                 n_prom_levels: int = 8, remat: bool = True, remat_policy: str | None = None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.d_model, self.n_layers, self.dtype = d_model, n_layers, dtype
        self.p_dropout, self.remat = p_dropout, remat
        self.remat_context = resolve_remat_policy(remat_policy)
        self.n_resp_tokens = n_tokens + (1 if use_stop_token else 0)
        self.text_emb = Embed(n_tokens, d_model, vocab=True)
        self.proms_emb = MultiEmbedding(n_prom_levels, n_tokens, d_model)
        self.resps_emb = MultiEmbedding(n_resp_levels, self.n_resp_tokens, d_model)
        self.sep = nn.Parameter(torch.zeros(d_model))
        for i in range(n_layers):
            self.add_module(f"block_{i}", PrenormBlock(d_model, n_heads, p_dropout, causal,
                                                       norm_type, n_resp_levels, dtype=dtype))
        self.classifier = Dense(d_model, self.n_resp_tokens, dtype=torch.float32, vocab=True)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    def _embed_merged(self, text, text_mask, proms, prom_mask, resps, resp_mask,
                      resp_level_mask=None):
        """The packed input (B, T, D) in the compute dtype, zero at padding
        slots, and its mask (B, T)."""
        B = text.shape[0]
        text_e = self.text_emb(text)
        proms_e = self.proms_emb(proms)
        resps_e = self.resps_emb(resps, resp_level_mask)
        sep = self.sep.expand(B, 1, self.d_model)
        dt = torch.promote_types(torch.promote_types(text_e.dtype, sep.dtype), proms_e.dtype)
        x = torch.cat([text_e.to(dt), sep.to(dt), proms_e.to(dt), sep.to(dt), resps_e.to(dt)], dim=1)
        mask, pos, _ = packed_layout(text_mask, prom_mask, resp_mask)
        x = x + sinusoidal_embedding(pos, self.d_model)
        return x.to(self.dtype) * mask[..., None].to(self.dtype), mask

    def forward(self, text, text_mask, proms, prom_mask, resps, resp_mask,
                resp_level_mask=None, quant_levels=None, generator=None, rows=None):
        """Logits (B, T, n_resp_tokens) over the merged layout.  A
        ``generator`` turns dropout on (one seed per block is drawn from it);
        without one the forward is deterministic.  ``rows``: a dp step's
        rows (``parallel.comm.Rows``), for the dropout masks."""
        B = text.shape[0]
        x, mask = self._embed_merged(text, text_mask, proms, prom_mask, resps, resp_mask,
                                     resp_level_mask)
        level = quant_levels if quant_levels is not None else torch.zeros(B, dtype=torch.long, device=text.device)
        seeds = [None] * self.n_layers
        if generator is not None and self.p_dropout > 0:
            seeds = torch.randint(2**62, (self.n_layers,), generator=generator,
                                  device=generator.device).tolist()
        use_remat = self.remat and torch.is_grad_enabled()
        for block, seed in zip(self.blocks(), seeds):
            x = (checkpoint(block, x, mask, level, seed, rows, use_reentrant=False,
                             context_fn=self.remat_context)
                 if use_remat else block(x, mask, level, seed, rows))
        logits = self.classifier(x.float())
        return logits * mask[..., None]

    # ---------------- incremental AR decoding ----------------

    @torch.no_grad()
    def prefill(self, text, text_mask, proms, prom_mask, total_len: int):
        """Run the ``[text | sep | prom | sep]`` prefix and fill a cache of
        ``total_len`` slots (prefix + the steps to come) → (logits at the
        second sep, slot ``prefix_len − 1``, (B, V) fp32; the cache)."""
        B = text.shape[0]
        resps = torch.zeros((B, 0, 1), dtype=torch.long, device=text.device)
        x, mask = self._embed_merged(text, text_mask, proms, prom_mask, resps,
                                     text_mask.new_zeros((B, 0)))
        P = x.shape[1]
        level = torch.zeros(B, dtype=torch.long, device=text.device)
        cache = KVCache(mask, total_len)
        for block in self.blocks():
            x, (k, v) = block.prefill(x, mask, level)
            cache.k.append(k.new_zeros((B, total_len, *k.shape[2:])))
            cache.v.append(v.new_zeros((B, total_len, *v.shape[2:])))
            cache.k[-1][:, :P] = k
            cache.v[-1][:, :P] = v
        return self.classifier(x[:, P - 1].float()), cache

    def decode_step(self, token, cache: "KVCache"):
        """One AR step: token (B,) → (logits (B, V) fp32, the cache, written
        in place)."""
        logits, cache = self.decode_chunk(token[:, None], cache.pos, cache)
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_chunk(self, tokens, pos0, cache: "KVCache"):
        """Teacher-forced decode of tokens (B, W): row b's token j sits at
        packed position ``pos0[b] + j`` and slot ``cache.index + j``.
        Returns (logits (B, W, V) fp32, the cache): ``logits[:, j]`` is the
        next-token distribution after ``tokens[:, :j + 1]``.  The W slots are
        marked valid; the speculative caller re-masks rejected ones."""
        B, W = tokens.shape
        pos = pos0[:, None] + torch.arange(W, device=tokens.device)
        emb = self.resps_emb(tokens[..., None]) + sinusoidal_embedding(pos, self.d_model)
        x = emb.to(self.dtype)
        index = cache.index
        cache.mask[:, index:index + W] = 1
        level = torch.zeros(B, dtype=torch.long, device=tokens.device)
        for block, ck, cv in zip(self.blocks(), cache.k, cache.v):
            x = block.decode(x, ck, cv, index, cache.mask, level)
        cache.index += W
        cache.pos += W
        return self.classifier(x.float()), cache


class KVCache:
    """The AR's decode state: per-layer k and v (B, Tc, H, Dh) in the
    compute dtype, the slots' validity (B, Tc), the next write slot
    ``index`` (a host int: every row writes the same slot) and each row's
    next packed position ``pos`` (B,).  Allocated once by ``prefill``; the
    decode paths write it in place."""

    def __init__(self, prefix_mask, total_len: int):
        B, P = prefix_mask.shape
        self.k: list[torch.Tensor] = []
        self.v: list[torch.Tensor] = []
        self.mask = prefix_mask.new_zeros((B, total_len))
        self.mask[:, :P] = prefix_mask
        self.index = P
        self.pos = prefix_mask.sum(dim=1).long()


IGNORE_INDEX = -100


def _shift_left(x):
    """x[:, 1:] with a zero column appended."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


def build_targets(text, text_mask, prom_mask, targ, resp_mask, *, resp_loss_only: bool,
                  shift: bool, stop_token: int | None):
    """The (B, T) targets over the merged layout, ``IGNORE_INDEX`` where no
    loss is taken.

    - ``resp_loss_only`` (NAR): only response slots, slot j targets
      ``targ[j]``;
    - otherwise (AR, ``shift``): text slot j targets ``text[j+1]`` (the last
      valid one is ignored), the prompt is ignored, the sep before the
      responses targets ``targ[0]``, response slot j targets ``targ[j+1]``
      and the last valid one ``stop_token``."""
    B, Tt = text.shape
    Tp = prom_mask.shape[1]
    ig = torch.full((B, 1), IGNORE_INDEX, dtype=torch.long, device=text.device)
    targ = targ.long()
    if resp_loss_only:
        t_text, t_prom = ig.expand(B, Tt), ig.expand(B, Tp)
        sep2 = ig
        t_resp = torch.where(resp_mask > 0, targ, IGNORE_INDEX)
    else:
        if not shift or stop_token is None:
            raise ValueError("the AR targets need shift=True and a stop token")
        t_text = torch.where((text_mask * _shift_left(text_mask)) > 0, _shift_left(text.long()),
                             IGNORE_INDEX)
        t_prom = ig.expand(B, Tp)
        has_resp = resp_mask.sum(dim=1, keepdim=True) > 0
        sep2 = torch.where(has_resp, targ[:, :1], IGNORE_INDEX)
        is_last = (resp_mask > 0) & (_shift_left(resp_mask) == 0)
        t_resp = torch.where(resp_mask > 0, _shift_left(targ), IGNORE_INDEX)
        t_resp = torch.where(is_last, stop_token, t_resp)
    return torch.cat([t_text, ig, t_prom, sep2, t_resp], dim=1)


def masked_cross_entropy(logits, targets, rows=None):
    """Mean cross-entropy (fp32 log-softmax) over the slots whose target is
    not ``IGNORE_INDEX``; in a dp step (``rows``), this rank's share of the
    global mean (its sum over the whole batch's count)."""
    valid = targets != IGNORE_INDEX
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, targets, 0)[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / global_sum(valid.sum(), rows).clamp(min=1)


def sample_categorical(logits, temperature: float = 1.0, gumbel_noise=None):
    """Temperature sampling with the noise passed in; ``temperature <= 0`` is
    greedy."""
    logits = logits.float()
    if temperature <= 0:
        return logits.argmax(dim=-1)
    if gumbel_noise is None:
        raise ValueError("stochastic sampling needs gumbel_noise")
    return (logits / temperature + gumbel_noise).argmax(dim=-1)
