"""Serving runtime (counterpart of ``serve.Synthesizer`` in the JAX
package), for a D3PM or an AR first stage.

One device batch runs the first stage, then NAR levels 1..7, then EnCodec:
- a D3PM first stage runs over the DiT denoiser at the serving response
  bucket (MaskGIT, the default, or the ancestral chain, every process step
  or a stride of them); the batch is decoded together at a fixed decode
  bucket and trimmed to ``gen_len`` frames;
- an AR first stage decodes up to ``max_ar_steps`` tokens over a KV cache
  (``ar_generate``, or ``ar_generate_speculative`` with a draft bundle); the
  NAR runs at the ``max_ar_steps`` response bucket with each row masked to
  its length, and each request is decoded alone at a 448-frame bucket and
  trimmed to its own length.
Requests are padded to fixed buckets: batch 1 or ``max_batch`` (pad rows
copy row 0 and are discarded), text ``text_len``, prompt the smallest
128-multiple covering the cohort's longest prompt.  Every row's sampling
noise derives only from its own seed, so a request's audio does not depend
on its cohort.

Not ported yet: the HTTP server, ``Batcher`` and long-form synthesis.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from .codec.encodec import HOP, SAMPLE_RATE, Codec
from .models.ar import AR, ar_generate, ar_generate_speculative
from .models.diffusion import DiffusionModel, ancestral_schedule
from .models.nar import NAR, nar_generate
from .utils.device import resolve_device
from .utils.rng import RowKeys


class Synthesizer:
    """text + reference wav → wav, for a D3PM or AR first stage + NAR + codec."""

    #: prompt-length buckets are 128-frame multiples
    PROM_BUCKET = 128
    #: codec-decode lengths pad up to multiples of this many frames (the
    #: decoder is causal, so trimming the padded tail is exact)
    DECODE_BUCKET = 448
    #: reference-wav encode cache capacity
    PROM_CACHE_CAP = 64
    #: an AR first stage's text and prompt buckets (a D3PM's come from its
    #: config)
    AR_TEXT_LEN, AR_PROM_LEN = 50, 398

    def __init__(self, first: DiffusionModel | AR, nar: NAR, codec: Codec, phone_symmap: dict,
                 *, device="cuda", max_batch: int = 1, decode: str | None = None,
                 stride: int = 1, maskgit_steps: int = 12, temperature: float = 1.0,
                 nar_temperature: float = 0.2, bf16: bool = True, max_ar_steps: int = 448,
                 draft: AR | None = None, spec_k: int = 4):
        """``decode`` is "maskgit" or "ancestral"; None means ancestral when
        ``stride`` > 1 (a knob of the ancestral chain), else MaskGIT.  A D3PM
        bundle's config sets the text, prompt and generation lengths; an AR
        first stage decodes up to ``max_ar_steps`` tokens, and a ``draft``
        AR turns on speculative decoding with ``spec_k`` proposals per
        round."""
        from .convert import cast_params_bf16

        self.device = resolve_device(device)
        self.is_ar = isinstance(first, AR)
        if not self.is_ar and not isinstance(first, DiffusionModel):
            raise ValueError("the first stage must be a D3PM diffusion model or an AR")
        if draft is not None:
            check_draft(first, draft)
        self.first = first.to(self.device).eval()
        self.nar = nar.to(self.device).eval()
        self.draft = draft.to(self.device).eval() if draft is not None else None
        if bf16:
            for m in (self.first, self.nar, self.draft):
                if m is not None:
                    cast_params_bf16(m)
        self.codec = codec
        self.phone_symmap = phone_symmap
        self.temperature = temperature
        self.nar_temperature = nar_temperature
        self.max_batch = max(1, int(max_batch))
        self._lock = threading.Lock()
        self._prom_cache: OrderedDict = OrderedDict()
        self._prom_cache_lock = threading.Lock()
        self.prom_cache_hits = self.prom_cache_misses = 0
        if self.is_ar:
            self.text_len, self.prom_len = self.AR_TEXT_LEN, self.AR_PROM_LEN
            self.max_ar_steps = max(1, int(max_ar_steps))
            self.spec_k = max(1, int(spec_k))
            self.decode = "ar speculative" if draft is not None else "ar"
            return
        c = first.config
        self.text_len, self.prom_len, self.gen_len = c.text_len, c.prom_len, c.gen_len
        self.decode = resolve_decode(decode, stride)
        self.stride = max(1, int(stride))
        self.maskgit_steps = max(1, min(int(maskgit_steps), c.gen_len))
        self.resp_bucket = c.serving_resp_bucket

    @classmethod
    def from_bundles(cls, ar_ckpt, nar_ckpt, codec_weights, *, device="cuda",
                     bf16: bool = True, draft_ckpt=None, **kw) -> "Synthesizer":
        """Load a first-stage bundle (D3PM or AR), a NAR bundle, converted
        codec weights (``codec_weights`` None: weights drawn from seed 0) and,
        for an AR first stage, an optional draft AR bundle."""
        from .bundle import load_meta
        from .codec.encodec import load_codec

        device = resolve_device(device)
        dtype = torch.bfloat16 if bf16 else torch.float32
        first_name = load_meta(ar_ckpt)["model"].lower()
        nar_name = load_meta(nar_ckpt)["model"].lower()
        if (first_name.startswith("diffusion-gaussian")
                or not first_name.startswith(("diffusion", "ar"))
                or not nar_name.startswith("nar")):
            raise NotImplementedError(
                f"{ar_ckpt} ({first_name}) + {nar_ckpt} ({nar_name}): not ported yet for "
                "serving (a D3PM diffusion or AR bundle with a NAR bundle is)")
        first, phone_symmap = load_model(ar_ckpt, dtype)
        nar, _ = load_model(nar_ckpt, dtype)
        draft = load_model(draft_ckpt, dtype)[0] if draft_ckpt is not None else None
        codec = load_codec(codec_weights, device=device)
        return cls(first, nar, codec, phone_symmap, device=device, bf16=bf16, draft=draft, **kw)

    # ---------------- request preparation (host) ----------------

    def phone_ids(self, text: str) -> list[int]:
        from .text import g2p
        from .text.symmap import phones_to_ids

        ids = phones_to_ids(g2p.encode(text), self.phone_symmap, strict=False)
        if not ids:
            raise ValueError("no usable phones in input text")
        if len(ids) > self.text_len:
            raise NotImplementedError(
                f"{len(ids)} phones exceed the text bucket {self.text_len}: "
                "long-form synthesis is not ported yet")
        return ids

    def prompt_codes(self, reference) -> np.ndarray:
        """Reference wav (a path, or a 24 kHz mono float array) → (t, 8)
        prompt codes.  Encodes of files are cached by (path, mtime, size) in
        an LRU that a lock guards, so concurrent callers may share it."""
        from .audio.wavio import read_wav

        if not isinstance(reference, (str, Path)):
            return self.codec.encode(np.asarray(reference, np.float32), SAMPLE_RATE).T
        st = Path(reference).stat()
        key = (str(Path(reference).resolve()), st.st_mtime_ns, st.st_size)
        with self._prom_cache_lock:
            hit = self._prom_cache.get(key)
            if hit is not None:
                self._prom_cache.move_to_end(key)
                self.prom_cache_hits += 1
                return hit
        wav, sr = read_wav(reference)
        codes = self.codec.encode(wav[:1] if wav.shape[0] == 2 else wav, sr).T
        with self._prom_cache_lock:
            self.prom_cache_misses += 1
            self._prom_cache[key] = codes
            self._prom_cache.move_to_end(key)
            while len(self._prom_cache) > self.PROM_CACHE_CAP:
                self._prom_cache.popitem(last=False)
        return codes

    @staticmethod
    def _pad(arr: np.ndarray, length: int, extra_dims=()):
        out = np.zeros((1, length, *extra_dims), np.int64)
        mask = np.zeros((1, length), np.float32)
        n = min(len(arr), length)
        out[0, :n] = arr[:n]
        mask[0, :n] = 1
        return out, mask

    def prepare(self, text: str, reference) -> dict:
        """Host-side request prep: g2p + codec encode + bucket padding."""
        ids = self.phone_ids(text)
        proms = self.prompt_codes(reference)
        text_a, text_m = self._pad(np.asarray(ids), self.text_len)
        prom_a, prom_m = self._pad(proms, self.prom_len, (8,))
        return dict(text=text_a, text_mask=text_m, proms=prom_a, prom_mask=prom_m,
                    prom_n=min(len(proms), self.prom_len))

    # ---------------- device batch ----------------

    def prompt_bucket(self, rows) -> int:
        pn = max(int(r["prom_n"]) for r in rows)
        return min(self.prom_len, max(1, -(-pn // self.PROM_BUCKET)) * self.PROM_BUCKET)

    @torch.no_grad()
    def _device_batch(self, prepared: list[dict], seeds: list[int], want_wav: bool = True):
        """Device stages for a cohort → (per-request (t, 8) codes: t =
        ``gen_len`` for a D3PM, the row's length for an AR; per-request
        float32 wavs or None)."""
        if not 1 <= len(prepared) <= self.max_batch:
            raise ValueError(f"need 1..{self.max_batch} requests")
        if len(seeds) != len(prepared):
            raise ValueError("need one seed per prepared row")
        n_req = len(prepared)
        pad_to = 1 if n_req == 1 else self.max_batch
        rows = prepared + [prepared[0]] * (pad_to - n_req)
        row_seeds = list(seeds) + [seeds[0]] * (pad_to - n_req)
        dev = self.device

        def stack(key):
            return torch.as_tensor(np.concatenate([r[key] for r in rows]), device=dev)

        pb = self.prompt_bucket(rows)
        text, tm = stack("text"), stack("text_mask")
        proms, pm = stack("proms")[:, :pb], stack("prom_mask")[:, :pb].contiguous()
        keys = RowKeys.from_seeds(row_seeds)
        with self._lock:
            if self.is_ar:
                return self._ar_batch(text, tm, proms, pm, keys, n_req, want_wav)
            if self.decode == "maskgit":
                toks = self.first.generate_maskgit(
                    text, tm, proms, pm, keys.fold(0), steps=self.maskgit_steps,
                    temperature=self.temperature, resp_bucket=self.resp_bucket)
            else:
                toks = self.first.generate(text, tm, proms, pm, keys.fold(0),
                                           stride=self.stride, resp_bucket=self.resp_bucket)
            toks = toks[:, : self.gen_len]
            rm = torch.ones((pad_to, self.gen_len), dtype=torch.float32, device=dev)
            codes = nar_generate(self.nar, text, tm, proms, pm, toks, rm, keys.fold(1),
                                 sampling_temperature=self.nar_temperature)
            wav = None
            if want_wav:
                d_bucket = max(1, -(-self.gen_len // self.DECODE_BUCKET)) * self.DECODE_BUCKET
                padded = torch.zeros((pad_to, d_bucket, 8), dtype=torch.long, device=dev)
                padded[:, : self.gen_len] = codes
                wav = self.codec.model.decode(padded.transpose(1, 2))[:, : self.gen_len * HOP, 0]
                wav = wav.cpu().numpy()
            codes = codes.cpu().numpy()
        wavs = [wav[i] for i in range(n_req)] if wav is not None else None
        return [codes[i] for i in range(n_req)], wavs

    def _ar_batch(self, text, tm, proms, pm, keys, n_req: int, want_wav: bool):
        """The AR first stage (plain or speculative) at ``max_ar_steps``, the
        NAR at that response bucket with per-row masks from the lengths, and
        each request's codes cut to its length (and decoded alone)."""
        if self.draft is not None:
            toks, lens = ar_generate_speculative(
                self.first, self.draft, text, tm, proms, pm, keys.fold(0),
                max_steps=self.max_ar_steps, k=self.spec_k,
                sampling_temperature=self.temperature)
        else:
            toks, lens = ar_generate(self.first, text, tm, proms, pm, keys.fold(0),
                                     max_steps=self.max_ar_steps,
                                     sampling_temperature=self.temperature)
        lens = lens.clamp(min=1)
        rm = (torch.arange(self.max_ar_steps, device=text.device)[None] < lens[:, None]).float()
        # a row whose first token is the stop keeps one frame; the stop id is
        # outside the NAR's and the codec's tables, so it becomes their last id
        lvl0 = torch.where(rm > 0, toks, 0).clamp(max=self.nar.n_tokens - 1)
        codes = nar_generate(self.nar, text, tm, proms, pm, lvl0, rm, keys.fold(1),
                             sampling_temperature=self.nar_temperature)
        codes, lens = codes.cpu().numpy(), lens.tolist()
        codes = [codes[i, : lens[i]] for i in range(n_req)]
        return codes, [self._decode_alone(c) for c in codes] if want_wav else None

    def _decode_alone(self, codes: np.ndarray) -> np.ndarray:
        """(t, 8) codes → float32 wav (t·HOP,): one request at a
        ``DECODE_BUCKET``-multiple, trimmed (the decoder is causal)."""
        t = len(codes)
        bucket = max(1, -(-t // self.DECODE_BUCKET)) * self.DECODE_BUCKET
        padded = torch.zeros((1, bucket, 8), dtype=torch.long, device=self.device)
        padded[0, :t] = torch.as_tensor(codes, device=self.device)
        return self.codec.model.decode(padded.transpose(1, 2))[0, : t * HOP, 0].cpu().numpy()

    def synthesize_codes_batch(self, prepared: list[dict], seeds: list[int]) -> list[np.ndarray]:
        return self._device_batch(prepared, seeds, want_wav=False)[0]

    def synthesize_batch(self, requests) -> list[tuple[np.ndarray, int]]:
        """Up to ``max_batch`` (text, reference, seed) requests in one device
        batch → [(wav float32 (T,), sample_rate)]."""
        if not 1 <= len(requests) <= self.max_batch:
            raise ValueError(f"need 1..{self.max_batch} requests")
        prepared = [self.prepare(t, ref) for t, ref, _ in requests]
        _, wavs = self._device_batch(prepared, [int(s) for _, _, s in requests])
        return [(w, self.sample_rate) for w in wavs]

    def synthesize(self, text: str, reference, seed: int = 0):
        """→ (wav float32 (T,), sample_rate)."""
        return self.synthesize_batch([(text, reference, seed)])[0]

    @property
    def denoiser_calls(self) -> int:
        """Denoiser evaluations of the first stage per batch: the MaskGIT
        steps, or one per process step of the ancestral chain's schedule."""
        if self.decode == "maskgit":
            return self.maskgit_steps
        return len(ancestral_schedule(self.first.config.timesteps, self.stride)[0])

    @property
    def sample_rate(self) -> int:
        return SAMPLE_RATE


def resolve_decode(decode: str | None, stride: int) -> str:
    """The first stage's sampler: ``decode`` when given, else "ancestral"
    for a stride above 1 and "maskgit" otherwise."""
    if decode is None:
        return "ancestral" if stride > 1 else "maskgit"
    if decode not in ("maskgit", "ancestral"):
        raise ValueError(f"unknown decode {decode!r} (maskgit or ancestral)")
    return decode


def check_draft(first, draft):
    """A draft must be an AR over the target's vocabulary (the JAX
    package's words)."""
    if not isinstance(draft, AR) or not isinstance(first, AR):
        raise ValueError("draft_ckpt requires AR bundles for both draft and first stage")
    if draft.n_tokens != first.n_tokens:
        raise ValueError(f"draft vocab ({draft.n_tokens}) must match the target's "
                         f"({first.n_tokens})")


def load_model(bundle, dtype=torch.bfloat16):
    """A bundle's model with its weights, on the CPU → (model, phone
    symmap)."""
    from . import convert
    from .bundle import load_bundle

    flat, meta, phone_symmap, _ = load_bundle(bundle)
    model = build_model(meta, dtype)
    convert.jax_params_to_torch(flat, getattr(model, "denoiser", model))
    return model, phone_symmap


def build_model(meta: dict, dtype=torch.bfloat16):
    """Rebuild an exported architecture from ``model.json``: the registry's
    dims (diffusion d512/8/8; ar, nar d1024/16/12; ``-half``, ``-quarter``)
    under the bundle's own ``d_model`` / ``n_heads`` / ``n_layers``."""
    from .models import get_model
    from .models.diffusion import DiffusionConfig

    name = meta["model"].lower()
    num_tokens = meta.get("num_tokens", 1024)
    if name.startswith("diffusion-gaussian"):
        raise NotImplementedError("the Gaussian diffusion family is not ported yet")
    if name.startswith("diffusion"):
        kw = {k: meta[k] for k in (
            "d_model", "n_heads", "n_layers", "timesteps", "resp_len", "text_len",
            "prom_len", "gen_len", "tower_ffn_dim", "tower_act", "resp_pe") if k in meta}
        return DiffusionModel(DiffusionConfig(n_classes=num_tokens + 1, **kw), dtype=dtype)
    if name.startswith(("ar", "nar")):
        dims = {k: meta[k] for k in ("d_model", "n_heads", "n_layers") if k in meta}
        return get_model(name, num_tokens, dims, dtype=dtype)
    raise ValueError(f"unknown model family {name!r}")
