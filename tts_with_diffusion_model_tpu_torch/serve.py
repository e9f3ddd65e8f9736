"""Serving runtime (counterpart of ``serve.py`` in the JAX package), for a
D3PM, a Gaussian or an AR first stage.

``Synthesizer`` runs one device batch: the first stage, then NAR levels
1..7, then EnCodec:
- a D3PM first stage runs over the DiT denoiser at the serving response
  bucket (MaskGIT, the default, or the ancestral chain, every process step
  or a stride of them); the batch is decoded together at a fixed decode
  bucket and trimmed to ``gen_len`` frames;
- a Gaussian first stage runs its whole reverse chain (``timesteps``
  denoiser calls) at the model's ``resp_len`` bucket, with no MaskGIT,
  stride or tight bucket (as the JAX package's), then the same NAR and
  decode;
- an AR first stage decodes up to ``max_ar_steps`` tokens over a KV cache
  (``ar_generate``, or ``ar_generate_speculative`` with a draft bundle); the
  NAR runs at the ``max_ar_steps`` response bucket with each row masked to
  its length, and each request is decoded alone at a 448-frame bucket and
  trimmed to its own length.
Requests are padded to fixed buckets: batch 1 or ``max_batch`` (pad rows
copy row 0 and are discarded), text ``text_len``, prompt the smallest
128-multiple covering the cohort's longest prompt.  Every row's sampling
noise derives only from its own seed, so a request's audio does not depend
on its cohort.  A text over the text bucket is synthesized in chained
segments (``longform.py``), and ``synthesize_stream`` yields one wav chunk
per segment.

Around it, a stdlib-only threaded HTTP API:
    GET  /healthz                         → {"status": "ok"}
    GET  /stats                           → counters, latency percentiles
         (p50/p90/p99 ms over a sliding window), batch occupancy, errors,
         rejections, uptime, prompt-cache hits / misses / size
    POST /tts  {"text": ..., "reference": <wav path>, "seed": 0}
                                           → audio/wav bytes
    POST /tts_stream  (same body)          → chunked audio/L16 PCM, one
         chunk per long-form segment
    python -m tts_with_diffusion_model_tpu_torch.serve --ar-ckpt zoo/ar \\
        --nar-ckpt zoo/nar [--device cuda] [--port 8400] \\
        [--max-batch 8 --batch-window-ms 10] [--max-pending 64]
``Batcher`` gathers concurrent requests into one device batch within a
window; at most ``max_pending`` requests are in flight, the rest are shed
with 503 and ``Retry-After``; SIGTERM and SIGINT drain in-flight requests.

Threads: every device batch runs on one thread (the Batcher's worker, or
the handler under ``_lock``), and so does each codec decode.  A handler's
prompt encode runs on the device outside ``_lock``, so it overlaps a batch
on another thread, as the JAX package's does; encodes hold ``_encode_lock``
among themselves, because the encoder (its cuDNN LSTM included) is one
module.
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import logging
import queue
import threading
import time
import wave
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from .codec.encodec import HOP, SAMPLE_RATE, Codec
from .models.ar import AR, ar_generate, ar_generate_speculative
from .models.diffusion import DiffusionModel, ancestral_schedule
from .models.gaussian_tts import GaussianDiffusionModel
from .models.nar import NAR, nar_generate
from .utils.device import resolve_device
from .utils.rng import RowKeys

_logger = logging.getLogger(__name__)


class Synthesizer:
    """text + reference wav → wav, for a D3PM, Gaussian or AR first stage +
    NAR + codec."""

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

    def __init__(self, first: DiffusionModel | GaussianDiffusionModel | AR, nar: NAR,
                 codec: Codec, phone_symmap: dict,
                 *, device="cuda", max_batch: int = 1, decode: str | None = None,
                 stride: int = 1, maskgit_steps: int = 12, temperature: float = 1.0,
                 nar_temperature: float = 0.2, bf16: bool = True, max_ar_steps: int = 448,
                 draft: AR | None = None, spec_k: int = 4):
        """``decode`` is "maskgit" or "ancestral"; None means ancestral when
        ``stride`` > 1 (a knob of the ancestral chain), else MaskGIT; both
        are the D3PM's and refused for a Gaussian first stage.  A diffusion
        bundle's config sets the text, prompt and generation lengths; an AR
        first stage decodes up to ``max_ar_steps`` tokens, and a ``draft``
        AR turns on speculative decoding with ``spec_k`` proposals per
        round."""
        from .utils.precision import cast_params_bf16

        self.device = resolve_device(device)
        self.is_ar = isinstance(first, AR)
        self.is_gaussian = isinstance(first, GaussianDiffusionModel)
        if not (self.is_ar or self.is_gaussian or isinstance(first, DiffusionModel)):
            raise ValueError("the first stage must be a D3PM or Gaussian diffusion model "
                             "or an AR")
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
        self._encode_lock = threading.Lock()
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
        if self.is_gaussian:
            if decode is not None or int(stride) != 1:
                raise ValueError(f"decode={decode!r} stride={stride} are D3PM samplers; a "
                                 "Gaussian first stage runs its whole reverse chain")
            self.decode, self.stride = "gaussian", 1
            self.resp_bucket = c.resp_len
            return
        self.decode = resolve_decode(decode, stride)
        self.stride = max(1, int(stride))
        self.maskgit_steps = max(1, min(int(maskgit_steps), c.gen_len))
        self.resp_bucket = c.serving_resp_bucket

    @classmethod
    def from_bundles(cls, ar_ckpt, nar_ckpt, codec_weights, *, device="cuda",
                     bf16: bool = True, draft_ckpt=None, **kw) -> "Synthesizer":
        """Load a first-stage bundle (D3PM, Gaussian or AR), a NAR bundle,
        converted codec weights (``codec_weights`` None: weights drawn from
        seed 0) and, for an AR first stage, an optional draft AR bundle."""
        from .bundle import load_meta
        from .codec.encodec import load_codec

        device = resolve_device(device)
        dtype = torch.bfloat16 if bf16 else torch.float32
        first_name = load_meta(ar_ckpt)["model"].lower()
        nar_name = load_meta(nar_ckpt)["model"].lower()
        if not first_name.startswith(("diffusion", "ar")) or not nar_name.startswith("nar"):
            raise ValueError(
                f"{ar_ckpt} ({first_name}) + {nar_ckpt} ({nar_name}): a first stage "
                "(diffusion, diffusion-gaussian* or ar*) and a nar* bundle are served")
        first, phone_symmap = load_model(ar_ckpt, dtype)
        nar, _ = load_model(nar_ckpt, dtype)
        draft = load_model(draft_ckpt, dtype)[0] if draft_ckpt is not None else None
        codec = load_codec(codec_weights, device=device)
        return cls(first, nar, codec, phone_symmap, device=device, bf16=bf16, draft=draft, **kw)

    # ---------------- request preparation (host) ----------------

    def phones_and_ids(self, text: str) -> tuple[list[str], list[int]]:
        """g2p and the symmap, once per request: the phones feed long-form
        segmentation, the ids the text bucket."""
        from .text import g2p
        from .text.symmap import phones_to_ids

        phones = g2p.encode(text)
        ids = phones_to_ids(phones, self.phone_symmap, strict=False)
        if not ids:
            raise ValueError("no usable phones in input text")
        return phones, ids

    def phone_ids(self, text: str) -> list[int]:
        return self.phones_and_ids(text)[1]

    def prompt_codes(self, reference) -> np.ndarray:
        """Reference wav (a path, or a 24 kHz mono float array) → (t, 8)
        prompt codes.  Encodes of files are cached by (path, mtime, size) in
        an LRU that a lock guards, so concurrent callers may share it."""
        from .audio.wavio import read_wav

        if not isinstance(reference, (str, Path)):
            with self._encode_lock:
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
        with self._encode_lock:
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

    def _prepare_ids(self, ids: list[int], proms: np.ndarray) -> dict:
        """Phone ids and (t, 8) prompt codes → one request row padded to the
        text and prompt buckets; ``prom_n`` keeps the prompt's length, so a
        cohort runs at the smallest prompt bucket covering it."""
        text_a, text_m = self._pad(np.asarray(ids), self.text_len)
        prom_a, prom_m = self._pad(proms, self.prom_len, (8,))
        return dict(text=text_a, text_mask=text_m, proms=prom_a, prom_mask=prom_m,
                    prom_n=min(len(proms), self.prom_len))

    def prepare(self, text: str, reference) -> dict:
        """Host-side request prep: g2p + codec encode + bucket padding (a
        text over the bucket is cut to it: ``synthesize`` sends such texts
        to long-form synthesis instead)."""
        return self._prepare_ids(self.phone_ids(text), self.prompt_codes(reference))

    # ---------------- device batch ----------------

    def prompt_bucket(self, rows) -> int:
        if getattr(self.first, "full_prompt", False):
            return self.prom_len
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
            if self.is_gaussian:
                toks = self.first.generate(text, tm, proms, pm, keys.fold(0))
            elif self.decode == "maskgit":
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

    @torch.no_grad()
    def _decode_alone(self, codes: np.ndarray) -> np.ndarray:
        """(t, 8) codes → float32 wav (t·HOP,): one request at a
        ``DECODE_BUCKET``-multiple, trimmed (the decoder is causal)."""
        t = len(codes)
        bucket = max(1, -(-t // self.DECODE_BUCKET)) * self.DECODE_BUCKET
        padded = torch.zeros((1, bucket, 8), dtype=torch.long, device=self.device)
        padded[0, :t] = torch.as_tensor(codes, device=self.device)
        return self.codec.model.decode(padded.transpose(1, 2))[0, : t * HOP, 0].cpu().numpy()

    def decode_codes(self, codes: np.ndarray) -> tuple[np.ndarray, int]:
        """(t, 8) codes → (wav float32 (t·HOP,), sample_rate), decoded at a
        ``DECODE_BUCKET``-multiple under the device lock."""
        with self._lock:
            return self._decode_alone(codes), self.sample_rate

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
        """→ (wav float32 (T,), sample_rate).  A text whose phones exceed
        the text bucket is synthesized in chained segments
        (``longform.synthesize_long``), not cut."""
        phones, ids = self.phones_and_ids(text)
        if len(ids) > self.text_len:
            from .longform import synthesize_long

            return synthesize_long(self, text, reference, seed=seed, phones=phones)
        row = self._prepare_ids(ids, self.prompt_codes(reference))
        return self._device_batch([row], [int(seed)], want_wav=True)[1][0], self.sample_rate

    def synthesize_stream(self, text: str, reference, seed: int = 0,
                          context_frames: int = 112, submit_row=None):
        """Generator of float32 wav chunks, one per long-form segment (one
        chunk for a text within the bucket), so the first audio of an
        N-segment request comes after one segment's latency.

        Each chunk is decoded with the previous ``context_frames`` codec
        frames as context and the context's samples dropped: the causal
        decoder gives the one-shot decode's samples up to the LSTM state
        beyond the context window, and ``context_frames`` covering every
        earlier frame makes the stream equal ``synthesize``.  The decoder
        pads inputs shorter than its first kernel, so chunks under ~8 codec
        frames are not prefix-exact; served segments are hundreds of frames.
        ``submit_row`` (``Batcher.submit_row``) sends each segment through a
        shared batching queue."""
        phones, ids = self.phones_and_ids(text)
        if len(ids) <= self.text_len:
            row = self._prepare_ids(ids, self.prompt_codes(reference))
            if submit_row is not None:
                codes = submit_row(row, int(seed))
            else:
                codes = self.synthesize_codes_batch([row], [int(seed)])[0]
            yield self.decode_codes(codes)[0]
            return

        from .longform import iter_segment_codes

        context: np.ndarray | None = None
        for codes in iter_segment_codes(self, text, reference, seed=seed, phones=phones,
                                        submit_row=submit_row):
            if context is None or not context_frames:
                wav, _ = self.decode_codes(codes)
            else:
                full, _ = self.decode_codes(np.concatenate([context, codes]))
                wav = full[len(context) * HOP:]
            merged = codes if context is None else np.concatenate([context, codes], axis=0)
            context = merged[-context_frames:] if context_frames else None
            yield wav

    #: the warm-up request's text
    WARMUP_TEXT = "warm up the compiler"

    def warmup(self, reference):
        """Pay each first-call cost before live traffic: the ``nvcc`` builds
        of the kernel libraries and their tensor-map encodes, cuDNN's LSTM
        set-up and the allocator's growth, at B = 1 and (when batching)
        ``max_batch``, with and without the wav decode, and for one
        long-form text (segment rows and a decode of the joined codes)."""
        text = self.WARMUP_TEXT
        self.synthesize(text, reference)
        row = self.prepare(text, reference)
        self.synthesize_codes_batch([row], [0])
        if self.max_batch > 1:
            self.synthesize_batch([(text, reference, 0)] * 2)
            self.synthesize_codes_batch([row] * 2, [0, 0])
        # repeats of the text: at least (text_len // n + 1) · n > text_len ids
        n = len(self.phone_ids(text))
        self.synthesize(" ".join([text] * (self.text_len // n + 1)), reference)
        _logger.info("Synthesizer warm")

    @property
    def denoiser_calls(self) -> int:
        """Denoiser evaluations of the first stage per batch: the MaskGIT
        steps, one per process step of the ancestral chain's schedule, or a
        Gaussian chain's ``timesteps``."""
        if self.is_gaussian:
            return self.first.config.timesteps
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
    dims (diffusion d512/8/8; ar, nar d1024/16/12; ``-half``, ``-quarter``;
    the Gaussian names' domain and denoiser) under the bundle's own
    hyperparameters (JSON lists become the config's tuples)."""
    from .models import get_model
    from .models.diffusion import DiffusionConfig

    name = meta["model"].lower()
    num_tokens = meta.get("num_tokens", 1024)
    if name.startswith("diffusion-gaussian"):
        ov = {k: tuple(meta[k]) if isinstance(meta[k], list) else meta[k] for k in (
            "d_model", "n_heads", "n_layers", "timesteps", "schedule", "domain", "resp_len",
            "text_len", "prom_len", "gen_len", "unet_dims", "denoiser", "unet_channels")
            if k in meta}
        return get_model(name, num_tokens, ov, dtype=dtype)
    if name.startswith("diffusion"):
        kw = {k: meta[k] for k in (
            "d_model", "n_heads", "n_layers", "timesteps", "resp_len", "text_len",
            "prom_len", "gen_len", "tower_ffn_dim", "tower_act", "resp_pe") if k in meta}
        return DiffusionModel(DiffusionConfig(n_classes=num_tokens + 1, **kw), dtype=dtype)
    if name.startswith(("ar", "nar")):
        dims = {k: meta[k] for k in ("d_model", "n_heads", "n_layers") if k in meta}
        return get_model(name, num_tokens, dims, dtype=dtype)
    raise ValueError(f"unknown model family {name!r}: the port builds diffusion, "
                     "diffusion-gaussian*, ar* and nar* bundles")


class Batcher:
    """Gather concurrent requests into device batches.

    The first queued request opens a window of ``window_ms``; whatever else
    arrives before it closes (up to ``synth.max_batch``) rides the same
    device batch, which the worker thread runs whole (the first stage, the
    NAR and the wav decode).  ``submit`` blocks until the request's result
    is ready; an error reaches every caller of the batch.
    """

    def __init__(self, synth: Synthesizer, window_ms: float = 10.0):
        self.synth = synth
        self.window_s = window_ms / 1e3
        self.q: queue.Queue = queue.Queue()
        self.stats: ServerStats | None = None  # set by make_server
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit_row(self, row: dict, seed: int = 0) -> np.ndarray:
        """Queue one prepared request row; blocks until the device batch
        carrying it completes and returns the row's (t, 8) codec codes."""
        return self._submit(row, seed, want_wav=False)[0]

    def _submit(self, row: dict, seed: int, want_wav: bool):
        """Queue one row → (codes, wav or None).  The batch decodes wavs
        when any of its rows wants one."""
        item = {"row": row, "seed": int(seed), "want_wav": bool(want_wav),
                "event": threading.Event(), "codes": None, "wav": None, "error": None}
        self.q.put(item)
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["codes"], item["wav"]

    def submit(self, text: str, reference, seed: int = 0):
        """(text, reference, seed) → (wav float32 (T,), sample_rate).  A
        long-form text's segments depend on each other (continuation
        prompts), so they ride the queue one at a time, each beside the
        concurrent traffic."""
        synth = self.synth
        phones, ids = synth.phones_and_ids(text)
        if len(ids) > synth.text_len:
            from .longform import synthesize_long

            return synthesize_long(synth, text, reference, seed=seed, phones=phones,
                                   submit_row=self.submit_row)
        row = synth._prepare_ids(ids, synth.prompt_codes(reference))
        return self._submit(row, seed, want_wav=True)[1], synth.sample_rate

    def _loop(self):
        while True:
            batch = [self.q.get()]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.synth.max_batch:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remain))
                except queue.Empty:
                    break
            if self.stats is not None:
                self.stats.record_batch(len(batch))
            try:
                codes, wavs = self.synth._device_batch(
                    [b["row"] for b in batch], [b["seed"] for b in batch],
                    want_wav=any(b["want_wav"] for b in batch))
                for i, (b, c) in enumerate(zip(batch, codes)):
                    b["codes"] = c
                    if wavs is not None:
                        b["wav"] = wavs[i]
            except Exception as e:  # noqa: BLE001 — delivered to every caller
                _logger.exception("device batch of %d failed", len(batch))
                for b in batch:
                    b["error"] = e
            for b in batch:
                b["event"].set()


class ServerStats:
    """Thread-safe serving counters and sliding-window latency percentiles."""

    WINDOW = 512  # latency samples kept for percentile estimates

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.time()
        self.requests = 0
        self.errors = 0
        self.streams = 0
        self.rejected = 0
        self.batches = 0
        self.batched_rows = 0
        self._lat_ms: list[float] = []

    def record(self, seconds: float, *, error: bool = False, stream: bool = False):
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            if stream:
                self.streams += 1
            self._lat_ms.append(seconds * 1e3)
            if len(self._lat_ms) > self.WINDOW:
                del self._lat_ms[: -self.WINDOW]

    def record_batch(self, n_rows: int):
        with self._lock:
            self.batches += 1
            self.batched_rows += n_rows

    def record_rejected(self):
        """A request shed with 503: counted apart from errors and kept out
        of the latency percentiles."""
        with self._lock:
            self.rejected += 1

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_ms)

            def pct(q):
                return round(lat[min(len(lat) - 1, int(q * len(lat)))], 1) if lat else None

            return {
                "uptime_s": round(time.time() - self._t0, 1),
                "requests": self.requests,
                "errors": self.errors,
                "rejected": self.rejected,
                "streams": self.streams,
                "latency_ms": {"p50": pct(0.5), "p90": pct(0.9), "p99": pct(0.99), "n": len(lat)},
                "batches": self.batches,
                "mean_batch_occupancy": (round(self.batched_rows / self.batches, 2)
                                         if self.batches else None),
            }


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """A float wav in [-1, 1] → the bytes of a 16-bit mono .wav file."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(wav, -1, 1) * 32767.0).astype("<i2").tobytes())
    return buf.getvalue()


def make_server(synth: Synthesizer, host: str = "127.0.0.1", port: int = 8400,
                batcher: Batcher | None = None, max_pending: int | None = 64):
    """A ``DrainingHTTPServer`` answering /healthz, /stats, /tts and
    /tts_stream through ``batcher`` (else ``synth`` directly); at most
    ``max_pending`` requests in flight across both POST endpoints (0 or None:
    no bound), the rest shed with 503 and ``Retry-After: 1``.  A request
    gives its admission slot back before the last bytes of its answer go
    out, so a client that reads its answer and posts again finds the slot
    free; the server's ``admit`` is the semaphore (None without a bound)."""
    submit = batcher.submit if batcher is not None else synth.synthesize
    submit_row = batcher.submit_row if batcher is not None else None
    stats = ServerStats()
    if batcher is not None:
        batcher.stats = stats

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for Transfer-Encoding: chunked on /tts_stream; every other
        # response sends Content-Length, as keep-alive requires
        protocol_version = "HTTP/1.1"
        #: the admission slot the request being answered holds, if any
        _slot = None

        def _release_slot(self):
            """Give the request's admission slot back, once."""
            slot, self._slot = self._slot, None
            if slot is not None:
                slot.release()

        def log_message(self, fmt, *args):
            _logger.info("%s - %s", self.address_string(), fmt % args)

        def _json(self, code: int, obj: dict, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self._release_slot()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                snap = stats.snapshot()
                with synth._prom_cache_lock:
                    snap["prom_cache"] = {"hits": synth.prom_cache_hits,
                                          "misses": synth.prom_cache_misses,
                                          "size": len(synth._prom_cache)}
                self._json(200, snap)
            else:
                self.send_error(404)

        def do_POST(self):
            handle = {"/tts": self._tts, "/tts_stream": self._tts_stream}.get(self.path)
            if handle is None:
                self.send_error(404)
                return
            admit = self.server.admit
            if admit is not None and not admit.acquire(blocking=False):
                stats.record_rejected()
                self._json(503, {"error": "overloaded", "retry_after_s": 1},
                           headers=[("Retry-After", "1")])
                return
            self._slot = admit
            try:
                handle()
            finally:
                self._release_slot()

        def _request(self) -> dict:
            return json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))

        def _tts(self):
            t0 = time.monotonic()
            recorded = False
            try:
                req = self._request()
                wav, sr = submit(req["text"], req["reference"], int(req.get("seed", 0)))
                body = wav_bytes(wav, sr)
                stats.record(time.monotonic() - t0)
                recorded = True
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self._release_slot()
                self.wfile.write(body)
            except Exception as e:  # noqa: BLE001 — answered with a 500
                _logger.exception("tts request failed")
                if recorded:  # synthesized and counted; the write failed
                    return
                stats.record(time.monotonic() - t0, error=True)
                self._json(500, {"error": str(e)})

        def _tts_stream(self):
            """Chunked big-endian 16-bit PCM (RFC 2586 L16), one chunk per
            long-form segment."""
            t0 = time.monotonic()
            try:
                req = self._request()
                gen = synth.synthesize_stream(req["text"], req["reference"],
                                              int(req.get("seed", 0)), submit_row=submit_row)
                first = next(gen)  # the first segment before the headers: errors → 500
                stats.record(time.monotonic() - t0, stream=True)
            except Exception as e:  # noqa: BLE001 — answered with a 500
                _logger.exception("tts_stream request failed")
                stats.record(time.monotonic() - t0, error=True, stream=True)
                self._json(500, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", f"audio/L16; rate={synth.sample_rate}; channels=1")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for wav in itertools.chain([first], gen):
                    data = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(">i2").tobytes()
                    self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()
                self._release_slot()
                self.wfile.write(b"0\r\n\r\n")
            except Exception:  # noqa: BLE001 — the headers are sent; only a drop is left
                _logger.exception("tts_stream aborted mid-stream")
                self.close_connection = True

    server = DrainingHTTPServer((host, port), Handler)
    server.admit = threading.Semaphore(max_pending) if max_pending and max_pending > 0 else None
    return server


class DrainingHTTPServer(ThreadingHTTPServer):
    """A ``ThreadingHTTPServer`` that finishes in-flight requests on shutdown:
    handler threads are not daemons and ``server_close`` joins them, which
    ``drain`` sequences after stopping the accept loop (what a load balancer
    expects of SIGTERM)."""

    daemon_threads = False
    block_on_close = True
    #: the listen backlog: a burst of connections must reach the admission
    #: bound (and its 503), not be reset by the kernel (socketserver's 5)
    request_queue_size = 128
    #: the ``max_pending`` semaphore (``make_server`` sets it; None: no bound)
    admit = None

    def drain(self):
        """Stop accepting, wait for in-flight handlers, release the port."""
        self.shutdown()
        self.server_close()


def main(argv=None):
    """The serving CLI: load the bundles, warm up, serve until SIGTERM or
    SIGINT, then drain the requests in flight and exit."""
    parser = argparse.ArgumentParser("TTS serving (PyTorch/CUDA)")
    parser.add_argument("--ar-ckpt", type=Path, default=Path("zoo/ar"),
                        help="first-stage bundle (an AR or a D3PM diffusion bundle)")
    parser.add_argument("--nar-ckpt", type=Path, default=Path("zoo/nar"))
    parser.add_argument("--codec", type=Path, default=None,
                        help="converted EnCodec weights (.npz); default $ENCODEC_WEIGHTS, "
                             "then zoo/encodec_24khz.npz, else weights drawn from seed 0")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8400, help="0: any free port")
    parser.add_argument("--warmup-reference", type=Path, default=None)
    parser.add_argument("--max-batch", type=int, default=1)
    parser.add_argument("--batch-window-ms", type=float, default=10.0)
    parser.add_argument("--max-ar-steps", type=int, default=448,
                        help="AR response bucket (AR first stages only)")
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--nar-temperature", type=float, default=0.2)
    parser.add_argument("--stride", type=int, default=1,
                        help="ancestral skip-step stride (D3PM bundles only)")
    parser.add_argument("--mesh-tp", type=int, default=1,
                        help="tensor-parallel degree (only 1 is ported)")
    parser.add_argument("--decode", choices=("ancestral", "maskgit"), default=None,
                        help="D3PM sampler (default: ancestral when --stride > 1, else maskgit)")
    parser.add_argument("--maskgit-steps", type=int, default=12)
    parser.add_argument("--draft-ckpt", type=Path, default=None,
                        help="AR draft bundle for speculative decoding (AR first stages)")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="draft tokens per speculative round")
    parser.add_argument("--max-pending", type=int, default=64,
                        help="requests in flight beyond this many are shed with 503 and "
                             "Retry-After (0: no bound)")
    args = parser.parse_args(argv)
    if args.mesh_tp > 1:
        parser.error(f"--mesh-tp {args.mesh_tp}: tensor-parallel serving is not ported yet "
                     "(ROADMAP.md queue 1 item 14, parallel/mesh.py and parallel/infer.py)")

    from .codec.encodec import find_weights

    logging.basicConfig(level=logging.INFO)
    try:
        synth = Synthesizer.from_bundles(
            args.ar_ckpt, args.nar_ckpt, find_weights(args.codec), device=args.device,
            max_batch=args.max_batch, decode=args.decode, stride=args.stride,
            maskgit_steps=args.maskgit_steps, max_ar_steps=args.max_ar_steps,
            draft_ckpt=args.draft_ckpt, spec_k=args.spec_k, temperature=args.temperature,
            nar_temperature=args.nar_temperature)
    except (NotImplementedError, ValueError) as e:
        parser.error(str(e))
    if args.warmup_reference:
        synth.warmup(args.warmup_reference)
    batcher = Batcher(synth, args.batch_window_ms) if args.max_batch > 1 else None
    server = make_server(synth, args.host, args.port, batcher, max_pending=args.max_pending)
    host, port = server.server_address[:2]
    _logger.info("Serving on http://%s:%d (max_batch=%d, device %s)", host, port,
                 synth.max_batch, synth.device)

    import signal

    def _drain(signum, _frame):
        # shutdown() blocks until serve_forever returns: not on the signal frame
        _logger.info("signal %d: draining in-flight requests", signum)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    server.serve_forever()
    server.server_close()  # joins in-flight handler threads
    _logger.info("drained; exiting")


if __name__ == "__main__":
    main()
