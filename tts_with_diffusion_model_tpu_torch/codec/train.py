"""Codec training: bootstrap an EnCodec-compatible codec from wavs
(counterpart of ``codec/train.py`` in the JAX package).

    python -m tts_with_diffusion_model_tpu_torch.codec.train yaml=<cfg> \\
        [data_dirs=[<wav folder>]] [device=cpu]

Trains the SEANet + RVQ model (``codec/encodec.py``) on fixed-length mono
segments drawn from the wavs under ``data_dirs``, with the reconstruction
objective of ``codec/losses.py`` (multi-scale STFT + L1 + VQ terms), on the
training runtime the TTS models use (``train/engine.Engine``: Adam at the
config's warmup-decay schedule, global-norm clipping).  Checkpoints are
``ckpt_dir/codec/step_<8 digits>.pt``, written every ``save_ckpt_every or
eval_every`` steps and at the end; a run resumes from the latest.  Under
``torchrun`` it trains on the config's mesh as the TTS models do: the codec
has no tp-tagged dimension, so tp replicates it, and dp splits the batch
(each rank draws ``batch_size // dp`` segments from its own stream).
"""

from __future__ import annotations

import logging
import random
import time
from pathlib import Path

import numpy as np
import torch

from ..audio.wavio import convert_audio, read_wav
from ..config import Config
from ..convert import init_seeded
from ..train import trainer
from ..data.dataset import _process_offset, local_batch_size
from ..train.engine import Engine
from ..train.train import setup_mesh
from ..utils.logging import setup_logging
from .encodec import HOP, SAMPLE_RATE, EncodecModel
from .losses import codec_reconstruction_loss

_logger = logging.getLogger(__name__)


class WavSegmentLoader:
    """Infinite loader of fixed-length mono 24 kHz segments from wav files:
    the JAX package's draws (Python ``random.Random(seed)``), so the same
    files and seed give the same batches."""

    def __init__(self, data_dirs, batch_size: int, segment_frames: int = 150, seed: int = 0):
        self.paths = []
        for d in data_dirs:
            self.paths.extend(Path(d).rglob("*.wav"))
        if not self.paths:
            raise RuntimeError(f"No wav files under {list(data_dirs)}")
        self.batch_size = batch_size
        self.segment_len = segment_frames * HOP
        self.rng = random.Random(seed)

    def _segment(self) -> np.ndarray:
        path = self.rng.choice(self.paths)
        wav, sr = read_wav(path)
        mono = convert_audio(wav, sr, SAMPLE_RATE, target_channels=1)
        if len(mono) >= self.segment_len:
            start = self.rng.randrange(0, len(mono) - self.segment_len + 1)
            return mono[start: start + self.segment_len]
        # a short file is tiled
        reps = int(np.ceil(self.segment_len / max(len(mono), 1)))
        return np.tile(mono, reps)[: self.segment_len]

    def __iter__(self):
        while True:
            batch = np.stack([self._segment() for _ in range(self.batch_size)])
            yield {"wav": batch[..., None].astype(np.float32)}


def make_codec_loss_fn(num_quantizers: int = 8):
    """The engine's loss feeder: ``(module, batch, generator) → (loss,
    stats)``; the objective draws no noise.  Its terms are means over equal
    rows, so in a dp step (``rows``) each rank's share is its mean times its
    rows' fraction of the global batch."""

    def loss_fn(module, batch, generator, rows=None):
        loss, stats = codec_reconstruction_loss(module, batch["wav"],
                                                num_quantizers=num_quantizers)
        if rows is None:
            return loss, stats
        share = rows.n / rows.total
        return loss * share, {k: v * share for k, v in stats.items()}

    return loss_fn


def train_codec(cfg: Config, segment_frames: int = 150, num_quantizers: int = 8,
                logger=trainer.logger) -> Engine:
    """Train until ``max_iter`` on ``cfg.device``; returns the engine.
    ``logger`` gets ``data=`` each step's stats (losses, ``lr``,
    ``grad_norm``, ``elapsed_time``: the host clock around the synchronised
    step, and ``global_step``)."""
    device, mesh = setup_mesh(cfg)
    model = EncodecModel()
    init_seeded(model, cfg.seed)
    model.to(device).train()

    opt_cfg = dict(cfg.optimizer_cfg)
    opt_cfg["gradient_clipping"] = cfg.gradient_clipping
    engine = Engine(name="codec", module=model, loss_fn=make_codec_loss_fn(num_quantizers),
                    opt_cfg=opt_cfg, ckpt_root=cfg.ckpt_dir, mesh=mesh)
    engine.load_checkpoint()

    loader = WavSegmentLoader(cfg.data_dirs, local_batch_size(cfg.batch_size, mesh),
                              segment_frames, cfg.seed + _process_offset(mesh))
    save_every = cfg.save_ckpt_every or cfg.eval_every
    for batch in loader:
        if engine.global_step >= cfg.max_iter:
            break
        t0 = time.perf_counter()
        stats = engine.train_batch(batch, None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        logger(data={**stats, "elapsed_time": time.perf_counter() - t0,
                     "global_step": engine.global_step})
        if save_every and engine.global_step % save_every == 0:
            engine.save_checkpoint()
    engine.save_checkpoint()
    return engine


def main(cfg: Config | None = None, logger=trainer.logger, segment_frames: int = 150) -> Engine:
    """The CLI; ``cfg`` None parses ``sys.argv``."""
    if cfg is None:
        cfg = Config.from_cli()
    setup_logging(cfg.log_dir)
    return train_codec(cfg, segment_frames=segment_frames, logger=logger)


if __name__ == "__main__":
    from ..utils.distributed import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
