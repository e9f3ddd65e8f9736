"""Long-form synthesis (counterpart of ``longform.py`` in the JAX package):
chained fixed-bucket segments, one seamless decode.

The first stages are bounded by their text bucket (50 phones for an AR, the
bundle's ``text_len`` for a D3PM).  Longer text is synthesized on the same
buckets:

  1. the phone stream is split at word boundaries (``"_"``, the g2p mark of
     spaces and punctuation) into segments that fit the first stage's text
     bucket;
  2. each segment is synthesized with a prompt of *reference codes*
     (speaker identity, always kept) plus the *tail of the previous
     segment's generated codes* (prosodic continuity);
  3. the segments' codec codes are concatenated and decoded **once**: the
     EnCodec decoder is convolutional over the whole code stream, so the
     joins need no crossfade.

Entry points: ``synthesize_long(synth, ...)`` on a ``serve.Synthesizer``
(its ``synthesize`` and ``Batcher.submit`` call it for over-long texts) and
the inference CLI's ``--segment-phones`` / automatic dispatch.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

WORD_SEP = "_"


def segment_phones(phones: list[str], max_len: int) -> list[list[str]]:
    """Split a phone sequence into chunks of at most ``max_len``, breaking at
    the last word separator before the limit (hard-splitting a single
    over-long word only as a last resort).  Chunks never start with a
    separator; separators otherwise stay in place so segment-internal timing
    matches the short path."""
    if max_len < 1:
        raise ValueError("max_len must be >= 1")
    segments: list[list[str]] = []
    start = 0
    n = len(phones)
    while start < n:
        while start < n and phones[start] == WORD_SEP:
            start += 1
        if start >= n:
            break
        end = min(start + max_len, n)
        if end < n:
            cut = -1
            for j in range(end - 1, start, -1):
                if phones[j] == WORD_SEP:
                    cut = j
                    break
            if cut > start:
                end = cut
        segments.append(phones[start:end])
        start = end
    return segments


def segment_seed(seed: int, i: int) -> int:
    """The seed of segment ``i`` of a request seeded ``seed`` (``seed + i``
    would collide across adjacent request seeds)."""
    return (int(seed) * 1_000_003 + i) & 0x7FFFFFFF


def iter_segment_codes(synth, text: str, reference: str | Path, seed: int = 0,
                       continuation_frames: int | None = None,
                       max_segment_phones: int | None = None,
                       phones: list[str] | None = None, submit_row=None):
    """Yield (t, 8) codec codes per chained segment of ``text``.

    ``continuation_frames`` controls how many frames of the previous
    segment's generated codes are appended to the reference prompt
    (default: a third of the prompt bucket); ``max_segment_phones`` caps the
    per-segment phone budget (default: the first stage's text bucket);
    ``phones`` skips re-running g2p when the caller already has the phone
    list; ``submit_row`` (a ``(row, seed) -> codes`` callable, e.g.
    ``serve.Batcher.submit_row``) routes each segment through a shared
    batching queue so segments coalesce with concurrent traffic; by default
    each segment is a device batch of one row.
    """
    from .text import g2p
    from .text.symmap import phones_to_ids

    max_phones = min(max_segment_phones or synth.text_len, synth.text_len)
    if phones is None:
        phones = g2p.encode(text)
    segments = segment_phones(phones, max_phones)
    if not segments:
        raise ValueError("no phones in input text")

    seg_ids = []
    for seg in segments:
        ids = phones_to_ids(seg, synth.phone_symmap, strict=False)
        if ids:
            seg_ids.append(ids)
    if not seg_ids:
        raise ValueError("no usable phones in input text")

    if continuation_frames is None:
        continuation_frames = synth.prom_len // 3
    continuation_frames = max(0, min(continuation_frames, synth.prom_len - 1))
    ref_codes = synth.prompt_codes(reference)
    ref_base = ref_codes[: synth.prom_len - continuation_frames]

    prev_tail: np.ndarray | None = None
    for i, ids in enumerate(seg_ids):
        if prev_tail is None or continuation_frames == 0:
            proms = ref_base
        else:
            proms = np.concatenate([ref_base, prev_tail], axis=0)
        row = synth._prepare_ids(ids, proms)
        derived = segment_seed(seed, i)
        if submit_row is not None:
            codes = submit_row(row, derived)
        else:
            codes = synth.synthesize_codes_batch([row], [derived])[0]
        yield codes
        if continuation_frames:
            prev_tail = codes[-continuation_frames:]


def synthesize_long(synth, text: str, reference: str | Path, seed: int = 0,
                    continuation_frames: int | None = None,
                    max_segment_phones: int | None = None,
                    phones: list[str] | None = None, submit_row=None):
    """Synthesize ``text`` of any length through a ``serve.Synthesizer``.

    Returns ``(wav float32 (T,), sample_rate)`` like ``synth.synthesize``.
    See ``iter_segment_codes`` for the parameters; the concatenated code
    stream is decoded in one convolutional pass (seam-free joins).
    """
    pieces = list(iter_segment_codes(
        synth, text, reference, seed=seed, continuation_frames=continuation_frames,
        max_segment_phones=max_segment_phones, phones=phones, submit_row=submit_row))
    return synth.decode_codes(np.concatenate(pieces, axis=0))
