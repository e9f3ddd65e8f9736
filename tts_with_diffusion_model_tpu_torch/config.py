"""Project configuration (copy of ``config.py`` in the JAX package,
≡ ``vall_e/config.py:10-99``).

Every field and default of the JAX package's ``Config``, so its YAML
configs load unchanged, plus ``make_spkr_getter`` and ``optimizer_cfg``.
In the port ``use_fp16`` selects bf16 compute with fp32 parameters, and
``device`` (from ``ConfigBase``) defaults to ``"cuda"``; under torchrun it
is each rank's card.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

from .utils.config_base import ConfigBase


def make_spkr_getter(spec: str):
    """Translate a speaker-name strategy into a callable Path -> str.

    Supported:
      - "parts:-3"          → p.parts[-3]
      - "dirname"           → p.parts[-2] (parent directory name)
      - "filename"          → p.parts[-1]
      - "stem-prefix:<sep>" → p.stem.split(sep)[0]
      - legacy "lambda p: p.parts[-N]" strings from reference YAMLs
        (``config/LibriTTS/ar.yml`` uses parts[-3]) parsed structurally —
        never eval'd.
    """
    spec = spec.strip()
    m = re.fullmatch(r"lambda\s+(\w+)\s*:\s*\1\.parts\[(-?\d+)\]", spec)
    if m:
        idx = int(m.group(2))
        return lambda p: Path(p).parts[idx]
    m = re.fullmatch(r"parts:(-?\d+)", spec)
    if m:
        idx = int(m.group(1))
        return lambda p: Path(p).parts[idx]
    if spec == "dirname":
        return lambda p: Path(p).parts[-2]
    if spec == "filename":
        return lambda p: Path(p).parts[-1]
    m = re.fullmatch(r"stem-prefix:(.+)", spec)
    if m:
        sep = m.group(1)
        return lambda p: Path(p).stem.split(sep)[0]
    m = re.fullmatch(r"lambda\s+(\w+)\s*:\s*\1\.stem\.split\([\"'](.+)[\"']\)\[0\]", spec)
    if m:
        sep = m.group(2)
        return lambda p: Path(p).stem.split(sep)[0]
    raise ValueError(
        f"Unsupported spkr_name_getter {spec!r}; use 'parts:N', 'dirname', "
        "'filename' or 'stem-prefix:<sep>'."
    )


@dataclass(frozen=True)
class Config(ConfigBase):
    # kept for reference-YAML compatibility; unused in the reference's own
    # committed code too (only a commented eval line, ``train.py:129``)
    data_root: Path = Path("data")
    data_dirs: list = field(default_factory=list)

    @property
    def sample_rate(self):
        return 24_000

    p_additional_prompt: float = 0.8
    max_prompts: int = 6

    max_num_val: int = 20
    max_val_ar_steps: int = 300

    token_dim: int = 256
    num_tokens: int = 1024

    nj: int = 8
    batch_size: int = 32
    eval_batch_size: int = 32
    warmup_min_lr: float = 1e-9
    warmup_max_lr: float = 1e-5
    # reference knob for GAN-discriminator engines (its multi-engine loop
    # supports them, ``utils/engines.py:137-140``); dead in the reference's
    # committed models too — kept for YAML compatibility
    dis_warmup_max_lr: float = 7e-5
    warmup_num_steps: int = 100
    max_iter: int = 1_000_000
    gradient_clipping: float = 1.0
    eval_every: int = 2_000
    save_ckpt_every: int | None = 2_000
    # checkpoint retention: newest N step dirs survive (DeepSpeed keeps all;
    # 3 bounds disk like the r3 runs did).  Raise it to keep every eval-tick
    # checkpoint selectable for post-hoc export (restore_step).
    ckpt_keep: int = 3
    # resume/export from this exact step instead of the latest checkpoint
    # (e.g. the val-loss minimum of an overfitting run); None = latest
    restore_step: int | None = None

    model: str = "ar-quarter"
    spkr_name_getter: str = "filename"

    min_phones: int = 10
    max_phones: int = 50

    use_fp16: bool = True  # → bf16 compute, fp32 parameters (no loss scaling needed)
    gradient_accumulation_steps: int = 1
    sampling_temperature: float = 1.0

    # memoize dataset construction (discovery, phone validation, symmaps)
    # to cache_dir (data/dataset.py create_datasets); delete cache_dir after
    # changing the data
    cache_dataloader: bool = False

    # static-shape bucket bounds (the reference pads per batch)
    max_text_len: int = 64
    max_prom_len: int = 896
    max_resp_len: int = 512

    # mesh shape: data-parallel × tensor-parallel axes over the ranks of a
    # torchrun group (parallel/mesh.py); -1 = all remaining
    mesh_dp: int = -1
    mesh_tp: int = 1

    # periodic torch.profiler trace capture: every N steps, record
    # `profile_n_steps` steps under log_dir/profile/step_<N>.  None = off.
    profile_every: int | None = None
    profile_n_steps: int = 3

    # Exponential moving average of parameters (e.g. 0.999), a diffusion
    # training staple the reference lacks; the averaged weights ride along
    # in checkpoints and export with `export --ema`.  None = off.
    ema_decay: float | None = None
    # evaluate the EMA weights instead of the raw ones (requires ema_decay)
    eval_use_ema: bool = False

    # ZeRO-1: each dp rank keeps its block of Adam's moments
    # (parallel/mesh.zero1_shardings)
    zero1: bool = False

    diffusion_train_mode: str = "sampled"  # "sampled" | "all_t" (ref parity)

    # per-block activation rematerialization during training (≡ the
    # reference's always-on ``poor_in_vram`` checkpointing, base.py:228-232);
    # lifts the trainable batch ceiling at ~1 extra forward of compute
    gradient_checkpointing: bool = True

    # remat granularity (models/base.resolve_remat_policy): null = recompute
    # whole blocks; "dots" saves the projections' matmul outputs, "dots_all"
    # every matmul's, "nothing" saves nothing
    gradient_checkpointing_policy: str | None = None

    # DiT self-attention implementation in the JAX package (null/"dense" =
    # XLA, "flash" = its training kernel).  Read for compatibility: in the
    # port every differentiated attention takes the training kernel and
    # every other one the serving kernel (ops/route.py), whatever it says
    attn_impl: str | None = None

    # optional per-run hyperparameter overrides for get_model (e.g. tiny
    # smoke-test models: {d_model: 64, n_layers: 2})
    model_overrides: dict | None = None

    # the C++ prefetching data loader (native/dataloader.cc via
    # data/native_loader.py); the Python loader when the dataset has no
    # .qnt.npy files or there is no g++
    use_native_loader: bool = True

    # Length-bucketed training batches (data/dataset.py
    # LengthBucketedLoader): re-group each window of batches by valid
    # response length and trim to the smallest listed bucket — cuts the
    # padding FLOPs the fixed 448-frame bound wastes on short utterances.
    # Masked loss/gradients are unchanged per sample.
    # e.g. resp_len_buckets: [192, 320, 448]
    resp_len_buckets: list | None = None
    prom_len_buckets: list | None = None
    bucket_window_batches: int = 8

    # decode hyp/ref wavs during eval into log_dir/<step>/<name>/{hyp,ref}
    # (the eval body the reference disabled, ``vall_e/train.py:90-145``)
    eval_decode_audio: bool = False

    # skip the per-step device sync: stats are fetched one step late so
    # dispatch overlaps device work (train/engine.py Engines.step); off =
    # exact per-step timing, the reference's cuda.synchronize semantics
    async_stats: bool = False

    @property
    def cache_dir(self) -> Path:
        return Path(".cache") / self.relpath

    @property
    def get_spkr(self):
        return make_spkr_getter(self.spkr_name_getter)

    @property
    def optimizer_cfg(self) -> dict:
        """The optimization recipe the reference encodes as DeepSpeed JSON
        (``vall_e/config.py:62-83``): Adam + linear warmup → decay + global
        norm clipping; bf16 compute instead of fp16 loss scaling."""
        return {
            "train_micro_batch_size_per_replica": self.batch_size,
            "gradient_accumulation_steps": self.gradient_accumulation_steps,
            "optimizer": {"type": "adam", "lr": self.warmup_min_lr},
            "scheduler": {
                "type": "warmup_decay",
                "warmup_min_lr": self.warmup_min_lr,
                "warmup_max_lr": self.warmup_max_lr,
                "warmup_num_steps": self.warmup_num_steps,
                "total_num_steps": self.max_iter,
            },
            "gradient_clipping": self.gradient_clipping,
            "bf16": {"enabled": self.use_fp16},
        }

