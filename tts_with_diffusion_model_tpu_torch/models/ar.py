"""AR model: the causal level-0 codec-token generator (counterpart of
``models/ar.py`` in the JAX package): one response level, a stop token,
LayerNorm blocks and a loss over the whole packed sequence with shifted
targets.

Training is one teacher-forced forward.  Generation prefills a KV cache
with the ``[text | sep | prompt | sep]`` prefix (the causal batch forward,
kernel 2 on the card) and decodes one token per step over the cache
(``ar_generate``), or lets a small draft propose ``k`` tokens per round for
the target to verify in one cached forward (``ar_generate_speculative``).

The JAX package compiles each loop into one program (``lax.scan``,
``lax.while_loop``).  Here each is a Python loop over in-place cache writes
with no host sync per step: a finished batch is noticed on the host every
``EXIT_CHECK_STEPS`` token positions, and the tokens are what the full loop
gives.  Sampling noise comes from per-row keys (``utils/rng.RowKeys``) with
the JAX package's tags.
"""

from __future__ import annotations

import torch
from torch import nn

from .base import Base, build_targets, masked_cross_entropy, sample_categorical

#: token positions between the host's checks that every row has stopped
EXIT_CHECK_STEPS = 16


class AR(nn.Module):
    def __init__(self, n_tokens: int, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 12, p_dropout: float = 0.1, remat: bool = True,
                 remat_policy=None, attn_impl=None, dtype=torch.bfloat16):
        """``attn_impl`` is read for compatibility: every attention takes the
        route of ``ops/route.py`` whatever it says."""
        super().__init__()
        self.n_tokens = n_tokens
        self.base = Base(n_tokens, d_model, n_heads, n_layers, p_dropout=p_dropout,
                         causal=True, n_resp_levels=1, use_stop_token=True, norm_type="ln",
                         remat=remat, remat_policy=remat_policy, dtype=dtype)

    @property
    def stop_token(self) -> int:
        return self.n_tokens

    def forward(self, text, text_mask, proms, prom_mask, resp, resp_mask, generator=None):
        """Teacher-forced training forward.  ``resp``: (B, Tr) level-0
        tokens.  A ``generator`` turns dropout on.  Returns (logits,
        {"nll": loss})."""
        logits = self.base(text, text_mask, proms, prom_mask, resp[..., None], resp_mask,
                           generator=generator)
        targets = build_targets(text, text_mask, prom_mask, resp, resp_mask,
                                resp_loss_only=False, shift=True, stop_token=self.stop_token)
        return logits, {"nll": masked_cross_entropy(logits, targets)}

    def prefill(self, text, text_mask, proms, prom_mask, total_len: int):
        return self.base.prefill(text, text_mask, proms, prom_mask, total_len)

    def decode_step(self, token, cache):
        return self.base.decode_step(token, cache)

    def decode_chunk(self, tokens, pos0, cache):
        return self.base.decode_chunk(tokens, pos0, cache)


def _lengths(tokens, stop: int, fallback):
    """The first stop's index per row, else ``fallback``."""
    is_stop = tokens == stop
    return torch.where(is_stop.any(dim=1), is_stop.int().argmax(dim=1), fallback)


@torch.no_grad()
def ar_generate(model: AR, text, text_mask, proms, prom_mask, keys, max_steps: int = 1000,
                sampling_temperature: float = 1.0):
    """Prefill, then one cached decode step per token.  ``keys``: per-row
    keys (``RowKeys``); step i's Gumbel noise is ``keys.fold(i)``'s draw,
    tag 0 for the first token.

    Returns (tokens (B, max_steps) = [tok0, nxt_1, …, nxt_{max_steps−1}],
    every token after a row's stop being ``stop``; lengths (B,): the first
    stop, or ``max_steps``).  Once every row has stopped (checked on the
    host every ``EXIT_CHECK_STEPS`` steps) the rest is ``stop`` without
    decoding: the same tokens the full loop gives."""
    B, Tt = text.shape
    prefix_len = Tt + 1 + proms.shape[1] + 1
    last_logits, cache = model.prefill(text, text_mask, proms, prom_mask, prefix_len + max_steps)
    stop = model.stop_token

    def sample(step: int, logits):
        if sampling_temperature <= 0:
            return sample_categorical(logits, 0.0)
        noise = keys.fold(step).gumbel(logits.shape[1:], logits.device)
        return sample_categorical(logits, sampling_temperature, gumbel_noise=noise)

    tokens = torch.full((B, max_steps), stop, dtype=torch.long, device=text.device)
    tok = sample(0, last_logits)
    tokens[:, 0] = tok
    stopped = tok == stop
    for i in range(1, max_steps):
        if i % EXIT_CHECK_STEPS == 0 and bool(stopped.all()):
            break
        logits, cache = model.decode_step(tok, cache)
        tok = torch.where(stopped, stop, sample(i, logits))
        stopped |= tok == stop
        tokens[:, i] = tok
    return tokens, _lengths(tokens, stop, max_steps)


def _mask_slots(mask, start: int, keep, width: int):
    """Re-mask one round's cache writes in place: slot ``start + j`` stays
    valid iff ``j <= keep[b]`` (the speculative rollback: rejected drafts
    become invisible to every later query, with no data movement)."""
    cols = torch.arange(width, device=mask.device)
    mask[:, start:start + width] = (cols[None, :] <= keep[:, None]).to(mask.dtype)


@torch.no_grad()
def ar_generate_speculative(target_model: AR, draft_model: AR, text, text_mask, proms, prom_mask,
                            keys, max_steps: int = 1000, k: int = 4,
                            sampling_temperature: float = 0.0, with_stats: bool = False):
    """Speculative AR decoding: the draft proposes ``k`` tokens per round,
    the target verifies them in one cached forward (``decode_chunk``), and
    the acceptance rule commits a prefix plus one corrected or bonus token.

    At ``sampling_temperature <= 0`` the output is the target's own greedy
    decode for any draft.  Above 0, the accept/residual scheme samples from
    the target's distribution; round r draws the draft's tokens with tags
    ``1 + r·(k + 4) + j``, the acceptance uniforms (k,) with ``+ k`` and the
    residual Gumbel noise with ``+ k + 1``.

    Rejected cache slots are masked out, not compacted, so the caches hold
    ``prefix + max_steps·(k + 1)`` slots.  Every round resets the draft's
    ``pos`` to the target's; writes past ``max_steps`` are dropped.  The
    loop ends once no row is active (checked on the host about every
    ``EXIT_CHECK_STEPS`` positions; the rounds run past that change
    nothing and are not counted).

    Returns (tokens (B, max_steps), lengths (B,)) as the JAX package does
    (the first stop, else the committed count); with ``with_stats`` also
    {"rounds": rounds run, "committed": per-row committed counts}."""
    B, Tt = text.shape
    dev = text.device
    stop = target_model.stop_token
    W = k + 1
    tau = sampling_temperature
    max_rounds = max_steps
    prefix_len = Tt + 1 + proms.shape[1] + 1
    total = prefix_len + max_rounds * W
    t_logits0, t_cache = target_model.prefill(text, text_mask, proms, prom_mask, total)
    _, d_cache = draft_model.prefill(text, text_mask, proms, prom_mask, total)
    TAGS = k + 4  # per-round tag stride: k draft draws + accept + residual

    def sample_from(logits, tag: int):
        if tau <= 0:
            return logits.argmax(dim=-1)
        noise = keys.fold(tag).gumbel(logits.shape[1:], dev)
        return (logits / tau + noise).argmax(dim=-1)

    y = sample_from(t_logits0, 0)
    buf = torch.zeros((B, max_steps + 1), dtype=torch.long, device=dev)  # last column: dropped
    buf[:, 0] = y
    cnt = torch.ones(B, dtype=torch.long, device=dev)
    stopped = y == stop
    pos_y = t_cache.pos.clone()
    rounds = torch.zeros((), dtype=torch.long, device=dev)
    cols = torch.arange(W, device=dev)[None, :]
    check_every = max(1, EXIT_CHECK_STEPS // W)

    for r in range(max_rounds):
        active = ~stopped & (cnt < max_steps)
        if r % check_every == 0 and not bool(active.any()):
            break
        rounds += active.any()
        base_tag = 1 + r * TAGS

        # draft: feed [y, x_1..x_k], propose x_1..x_k
        d_cache.pos.copy_(pos_y)
        d_index0 = d_cache.index
        tok, xs, q_fulls = y, [], []
        for j in range(W):
            logits, d_cache = draft_model.decode_step(tok, d_cache)
            if j < k:
                tok = sample_from(logits, base_tag + j)
                xs.append(tok)
                if tau > 0:
                    q_fulls.append(torch.softmax(logits / tau, dim=-1))
        x = torch.stack(xs, dim=1)  # (B, k)

        # the target verifies the whole chunk in one forward
        t_index0 = t_cache.index
        t_logits, t_cache = target_model.decode_chunk(torch.cat([y[:, None], x], dim=1), pos_y,
                                                      t_cache)
        if tau <= 0:
            accept = x == t_logits.argmax(dim=-1)[:, :k]
        else:
            p = torch.softmax(t_logits / tau, dim=-1)
            q_full = torch.stack(q_fulls, dim=1)
            p_at = p[:, :k].gather(-1, x[..., None])[..., 0]
            q_at = q_full.gather(-1, x[..., None])[..., 0]
            u = keys.fold(base_tag + k).uniform((k,), dev)
            accept = u < (p_at / q_at.clamp_min(1e-20)).clamp(0.0, 1.0)
        n = torch.where(accept.all(dim=1), k, accept.int().argmin(dim=1))

        # replacement (n < k: the residual) or bonus (n == k: the target)
        V = t_logits.shape[-1]
        sel_logits = t_logits.gather(1, n[:, None, None].expand(B, 1, V))[:, 0]
        if tau <= 0:
            y_new = sel_logits.argmax(dim=-1)
        else:
            p_sel = torch.softmax(sel_logits / tau, dim=-1)
            q_ext = torch.cat([q_full, torch.zeros_like(q_full[:, :1])], dim=1)
            q_sel = q_ext.gather(1, n[:, None, None].expand(B, 1, V))[:, 0]
            res = (p_sel - q_sel).clamp_min(0.0)
            norm = res.sum(dim=-1, keepdim=True)
            res = torch.where(norm > 1e-12, res / norm.clamp_min(1e-12), p_sel)
            g = keys.fold(base_tag + k + 1).gumbel((V,), dev)
            y_new = (torch.log(res + 1e-30) + g).argmax(dim=-1)

        # rollback: rejected entries become invisible
        _mask_slots(t_cache.mask, t_index0, n, W)
        _mask_slots(d_cache.mask, d_index0, n, W)

        # commit x_1..x_n, then y_new
        xpad = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        vals = torch.where(cols == n[:, None], y_new[:, None], xpad)
        write_pos = torch.where(cols <= n[:, None], cnt[:, None] + cols, max_steps)
        write_pos = torch.where(stopped[:, None], max_steps, write_pos).clamp(max=max_steps)
        buf.scatter_(1, write_pos, vals)
        committed_stop = ((cols <= n[:, None]) & (vals == stop) & ~stopped[:, None]).any(dim=1)
        cnt = torch.where(stopped, cnt, (cnt + n + 1).clamp(max=max_steps))
        stopped = stopped | committed_stop
        y = y_new
        pos_y = pos_y + n + 1

    tokens = buf[:, :max_steps]
    lengths = _lengths(tokens, stop, cnt)
    if with_stats:
        return tokens, lengths, {"rounds": rounds, "committed": cnt}
    return tokens, lengths
