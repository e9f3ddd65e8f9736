"""Dataset + static-shape batching (copy of ``data/dataset.py`` in the JAX
package's Python loader, ≡ ``vall_e/data.py``).

The on-disk contract and split semantics are the JAX package's:
  - artifacts per utterance: ``X.qnt.npy`` (int16/int32 ``(8, t)`` codec
    codes; ``X.qnt.pt`` tensors of shape ``(1, 8, t)`` are also read) and
    ``X.phn.txt`` (space-joined phonemes, wrapped with <s>/</s> at load);
  - phone-count validation, phone symmap indexed from 1 so 0 pads, speaker
    symmap from data;
  - per-speaker 95/5 train/val split with fixed seed 0;
  - prompt sampling: concat 1..max_prompts other utterances of the same
    speaker with continuation prob ``p_additional_prompt``;
  - speaker-balanced training sampling via the hierarchical Sampler; val
    interleave-by-speaker + head truncation;
  - dense static-shape buckets (text / prom / resp padded to configured
    bounds with masks), optionally trimmed per batch by
    ``LengthBucketedLoader``.

All of it is host code drawing from seeded ``random.Random`` streams, so
with the same seed (and one loader thread) the port yields the same batches
as the JAX package's Python loader.  Training batches come from the C++
loader (``native_loader.py``) by default, as in the JAX package; dataset
construction can be memoized to ``cfg.cache_dir`` (``cache_dataloader``).
"""

from __future__ import annotations

import logging
import random
from collections import defaultdict
from functools import lru_cache
from itertools import groupby, zip_longest
from pathlib import Path
from typing import Sequence

import numpy as np

from ..utils.distributed import all_reduce_max_int, broadcast_object, global_rank
from .sampler import Sampler

_logger = logging.getLogger(__name__)


def _replace_file_extension(path: Path, suffix: str) -> Path:
    return (path.parent / path.name.split(".")[0]).with_suffix(suffix)


def load_quants(path: Path) -> np.ndarray:
    """Load codec codes for an utterance → (t, 8) int32 (≡ ``data.py:31-37``)."""
    npy = _replace_file_extension(path, ".qnt.npy")
    if npy.exists():
        q = np.load(npy)
        if q.ndim == 3:  # (1, 8, t)
            q = q[0]
        return np.ascontiguousarray(q.T.astype(np.int32))  # (t, 8)
    pt = _replace_file_extension(path, ".qnt.pt")
    if pt.exists():
        import torch

        q = torch.load(pt, map_location="cpu", weights_only=True)
        return np.ascontiguousarray(q[0].t().numpy().astype(np.int32))
    raise FileNotFoundError(f"No quant artifact for {path}")


@lru_cache(maxsize=None)
def get_phones(path: Path) -> tuple[str, ...]:
    p = _replace_file_extension(Path(path), ".phn.txt")
    content = p.read_text(encoding="utf8")
    return tuple(["<s>"] + content.split() + ["</s>"])


def validate_path(path: Path, min_phones: int, max_phones: int) -> bool:
    """Keep utterances whose phone count is in range (≡ ``data.py:59-71``)."""
    try:
        phones = get_phones(path)
    except FileNotFoundError:
        return False
    unique = set(phones)
    if not unique or unique == {"_"}:
        return False
    return min_phones <= len(phones) <= max_phones


def _interleaved_reorder(items, fn):
    groups = defaultdict(list)
    for e in items:
        groups[fn(e)].append(e)
    groups = {k: groups[k] for k in sorted(groups)}
    out = []
    for interleaved in zip_longest(*groups.values()):
        out.extend(v for v in interleaved if v is not None)
    return out


class VALLEDataset:
    """Utterances of ``paths`` with their phones, prompts and codes; in
    training mode ``__getitem__`` ignores the index and draws a
    speaker-balanced sample."""

    def __init__(
        self,
        paths: Sequence[Path],
        get_spkr,
        phone_symmap: dict | None = None,
        spkr_symmap: dict | None = None,
        min_phones: int = 10,
        max_phones: int = 50,
        training: bool = False,
        p_additional_prompt: float = 0.8,
        max_prompts: int = 6,
        extra_paths_by_spkr_name: dict | None = None,
        seed: int = 0,
        skip_validation: bool = False,
    ):
        self.get_spkr = get_spkr
        self.min_phones = min_phones
        self.max_phones = max_phones
        self.p_additional_prompt = p_additional_prompt
        self.max_prompts = max_prompts
        self.training = training
        self._head: int | None = None
        self.rng = random.Random(seed)

        if skip_validation:  # paths come pre-validated from the disk cache
            self.paths = list(paths)
        else:
            self.paths = [p for p in paths if validate_path(p, min_phones, max_phones)]
        if len(self.paths) == 0 and training:
            raise ValueError("No valid path found for training.")

        self.spkr_symmap = spkr_symmap or self._make_spkr_symmap()
        self.phone_symmap = phone_symmap or self._make_phone_symmap()

        self.paths_by_spkr_name = defaultdict(list)
        for p in self.paths:
            self.paths_by_spkr_name[self.get_spkr(p)].append(p)
        for k, v in (extra_paths_by_spkr_name or {}).items():
            self.paths_by_spkr_name[k].extend(v)
        self.paths_by_spkr_name = dict(self.paths_by_spkr_name)

        self.sampler = (
            Sampler(self.paths, [self.get_spkr], rng=self.rng) if training else None
        )

    @property
    def phones(self):
        s = set()
        for p in self.paths:
            s.update(get_phones(p))
        return sorted(s)

    def _make_phone_symmap(self):
        # indexed from 1 so 0 is the pad id (≡ ``data.py:126``)
        return {s: i for i, s in enumerate(self.phones, 1)}

    @property
    def spkrs(self):
        return sorted({self.get_spkr(p) for p in self.paths})

    def _make_spkr_symmap(self):
        return {s: i for i, s in enumerate(self.spkrs)}

    def sample_prompts(self, spkr_name: str, ignore: Path) -> np.ndarray:
        """Concatenate 1..max_prompts same-speaker utterances
        (≡ ``data.py:136-155``)."""
        choices = [p for p in self.paths_by_spkr_name[spkr_name] if p != ignore]
        if not choices:
            raise ValueError(
                f"Failed to find another different utterance for {spkr_name}."
            )
        prom_list = []
        for _ in range(self.max_prompts):
            prom_list.append(load_quants(self.rng.choice(choices)))
            if self.rng.random() > self.p_additional_prompt:
                break
        return np.concatenate(prom_list, axis=0)

    def __getitem__(self, index: int) -> dict:
        if self.training:
            path = self.sampler.sample()
        else:
            path = self.paths[index]
        spkr_name = self.get_spkr(path)
        text = np.array(
            [self.phone_symmap[p] for p in get_phones(path)], dtype=np.int32
        )
        proms = self.sample_prompts(spkr_name, ignore=path)
        resps = load_quants(path)
        return dict(
            path=path,
            spkr_name=spkr_name,
            text=text,
            proms=proms,       # (t', 8)
            resps=resps,       # (t, 8)
            resp=resps[:, 0],  # (t,)
        )

    def head_(self, n: int):
        self._head = n

    def training_(self, value: bool):
        self.training = value

    def interleaved_reorder_(self, fn):
        self.paths = _interleaved_reorder(self.paths, fn)

    def __len__(self):
        return min(len(self.paths), self._head or len(self.paths))



def load_train_val_paths(data_dirs: Sequence[Path], get_spkr):
    """Discover ``*.qnt.*`` artifacts and split 95/5 per speaker with the
    reference's fixed seed 0 (≡ ``data.py:216-241``)."""
    paths = []
    for d in data_dirs:
        paths.extend(Path(d).rglob("*.qnt.pt"))
        paths.extend(Path(d).rglob("*.qnt.npy"))
    if not paths:
        raise RuntimeError(f"Failed to find any quant artifact in {list(data_dirs)}.")

    pairs = sorted((get_spkr(p), p) for p in paths)
    train_paths, val_paths = [], []
    for _, group in groupby(pairs, lambda pair: pair[0]):
        grp = sorted(p for _, p in group)
        random.Random(0).shuffle(grp)
        n = round(len(grp) * 0.95)
        train_paths.extend(grp[:n])
        val_paths.extend(grp[n:])
    return sorted(train_paths), sorted(val_paths)


class BucketSpec:
    """Static pad bounds for one batch layout."""

    def __init__(self, text_len: int, prom_len: int, resp_len: int, n_levels: int = 8):
        self.text_len = text_len
        self.prom_len = prom_len
        self.resp_len = resp_len
        self.n_levels = n_levels


def collate(samples: list[dict], bucket: BucketSpec) -> dict:
    """Dense static-shape collation (replaces the reference's ragged
    list-of-dicts collate, ``data.py:192-194``).

    Truncates to the bucket bound (the reference's diffusion path does the
    same at 448/398/50, ``ar_discrete.py:592-626``) and emits masks.
    """
    B = len(samples)
    text = np.zeros((B, bucket.text_len), np.int32)
    text_mask = np.zeros((B, bucket.text_len), np.float32)
    proms = np.zeros((B, bucket.prom_len, bucket.n_levels), np.int32)
    prom_mask = np.zeros((B, bucket.prom_len), np.float32)
    resps = np.zeros((B, bucket.resp_len, bucket.n_levels), np.int32)
    resp_mask = np.zeros((B, bucket.resp_len), np.float32)

    for i, s in enumerate(samples):
        t = s["text"][: bucket.text_len]
        text[i, : len(t)] = t
        text_mask[i, : len(t)] = 1
        p = s["proms"][: bucket.prom_len]
        proms[i, : len(p)] = p
        prom_mask[i, : len(p)] = 1
        r = s["resps"][: bucket.resp_len]
        resps[i, : len(r)] = r
        resp_mask[i, : len(r)] = 1

    return dict(
        path=[s["path"] for s in samples],
        spkr_name=[s["spkr_name"] for s in samples],
        text=text,
        text_mask=text_mask,
        proms=proms,
        prom_mask=prom_mask,
        resps=resps,
        resp=resps[..., 0],
        resp_mask=resp_mask,
    )


class DataLoader:
    """Batched loader over a VALLEDataset.

    Training mode draws speaker-balanced random samples forever on ``nj``
    background threads feeding a bounded queue (≡ the reference's torch
    DataLoader with 8 persistent workers, ``data.py:197-213`` — numpy file
    IO releases the GIL, so threads overlap; sample *selection* is IID
    random draws, so worker interleaving is harmless).  Eval mode iterates
    sequentially once.
    """

    #: which loader makes the training batches (``NativeDataLoader``: "native")
    kind = "python"

    def __init__(self, dataset: VALLEDataset, batch_size: int, bucket: BucketSpec,
                 training: bool = True, drop_last: bool | None = None,
                 nj: int = 4, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.bucket = bucket
        self.training = training
        self.drop_last = training if drop_last is None else drop_last
        self.nj = max(1, nj)
        self.prefetch = max(1, prefetch)

    def _iter_threaded(self):
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            # A worker exception must reach the training loop: a dead
            # worker with no error channel would leave the main thread
            # blocked on q.get() forever (silent mid-training stall).
            try:
                while not stop.is_set():
                    samples = [self.dataset[0] for _ in range(self.batch_size)]
                    batch = collate(samples, self.bucket)
                    while not stop.is_set():
                        try:
                            q.put(("batch", batch), timeout=0.2)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # noqa: BLE001 — re-raised by consumer
                while not stop.is_set():
                    try:
                        q.put(("error", e), timeout=0.2)
                        break
                    except queue.Full:
                        continue

        threads = [
            threading.Thread(target=worker, daemon=True, name=f"loader-{i}")
            for i in range(self.nj)
        ]
        for t in threads:
            t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()

    def __iter__(self):
        if self.training:
            yield from self._iter_threaded()
        else:
            n = len(self.dataset)
            for start in range(0, n, self.batch_size):
                idx = range(start, min(start + self.batch_size, n))
                if self.drop_last and len(idx) < self.batch_size:
                    return
                yield collate([self.dataset[i] for i in idx], self.bucket)

    def __len__(self):
        if self.training:
            raise TypeError("Training loader is infinite")
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


class LengthBucketedLoader:
    """Length-grouped re-batching over an infinite training loader.

    The reference pads every batch to the full resp/prom bounds (448/398),
    so short utterances spend compute on masked positions.  This wrapper
    pulls a window of ``window`` batches from the base loader, re-groups the
    window's samples by valid response length, trims each group to the
    smallest allowed bucket that covers it, and emits the groups in shuffled
    order.  The shapes come from a small fixed set, the batch size never
    changes, and masks make the per-sample loss and gradients identical to
    the full-bucket collation.  Speaker balance is preserved in expectation:
    grouping only reorders samples *within* a window drawn by the balanced
    sampler.
    """

    def __init__(self, base, bucket: BucketSpec, resp_buckets,
                 prom_buckets=None, window: int = 8, seed: int = 0, dp=None):
        self.base = base
        self.dp = dp  # the loading ranks' mesh axis (None: every rank loads)
        self.bucket = bucket
        self.resp_buckets = sorted(
            {int(b) for b in resp_buckets if int(b) <= bucket.resp_len}
            | {bucket.resp_len}
        )
        self.prom_buckets = (
            sorted({int(b) for b in prom_buckets if int(b) <= bucket.prom_len}
                   | {bucket.prom_len})
            if prom_buckets else None
        )
        self.window = max(1, int(window))
        self.seed = seed

    @property
    def dataset(self):
        return self.base.dataset

    @property
    def kind(self) -> str:
        return self.base.kind

    def close(self):
        close = getattr(self.base, "close", None)
        if close is not None:
            close()

    def _agree(self, need: int) -> int:
        """The max of ``need`` over the ranks that load: every rank draws
        different rows, and a dp step's ranks must agree on the shape."""
        if self.dp is None:
            return all_reduce_max_int(need)
        return need if self.dp.size == 1 else all_reduce_max_int(need, self.dp.group)

    @staticmethod
    def _pick(buckets: list[int], need: int) -> int:
        for b in buckets:
            if b >= need:
                return b
        return buckets[-1]

    def __iter__(self):
        rng = random.Random(self.seed)
        it = iter(self.base)
        while True:
            window = [next(it) for _ in range(self.window)]
            B = window[0]["resp_mask"].shape[0]
            merged = {}
            for k, v0 in window[0].items():
                if isinstance(v0, np.ndarray):
                    merged[k] = np.concatenate([w[k] for w in window], axis=0)
                else:  # path / spkr_name lists
                    merged[k] = [x for w in window for x in w[k]]
            # valid lengths from the masks (pads are a contiguous suffix)
            rlens = merged["resp_mask"].sum(axis=1).astype(np.int64)
            order = np.argsort(rlens, kind="stable")
            groups = [order[i * B:(i + 1) * B] for i in range(self.window)]
            rng.shuffle(groups)
            for g in groups:
                out = {
                    k: (v[g] if isinstance(v, np.ndarray) else [v[i] for i in g])
                    for k, v in merged.items()
                }
                r_need = self._agree(int(out["resp_mask"].sum(axis=1).max()))
                R = self._pick(self.resp_buckets, r_need)
                for k in ("resps", "resp", "resp_mask"):
                    out[k] = out[k][:, :R]
                if self.prom_buckets:
                    p_need = self._agree(int(out["prom_mask"].sum(axis=1).max()))
                    P = self._pick(self.prom_buckets, p_need)
                    out["proms"] = out["proms"][:, :P]
                    out["prom_mask"] = out["prom_mask"][:, :P]
                yield out


class TensorParallelRowLoader:
    """One stream of training batches for a tp row, whose ranks compute one
    batch together: the row's first rank iterates ``base`` and broadcasts
    each batch over the row, the others (``base`` None) receive it.  Loading
    on every rank of the row would not do, even from one seed: the loaders
    fill batches on several threads and hand them out in the order those
    finish."""

    def __init__(self, base, dataset, kind: str, mesh):
        self.base, self.dataset, self.kind = base, dataset, kind
        self.group, self.src = mesh.tp.group, mesh.rank - mesh.tp.rank

    def close(self):
        close = getattr(self.base, "close", None)
        if close is not None:
            close()

    def __iter__(self):
        it = iter(self.base) if self.base is not None else None
        while True:
            batch = broadcast_object(next(it, None) if it is not None else None, self.src,
                                     self.group)
            if batch is None:
                return
            yield batch


def _dataset_cache_file(cfg) -> Path:
    """Cache file of ``create_datasets`` (the JAX package's name for the same
    cfg), keyed on the construction inputs only: the cache does not watch
    the filesystem, so delete ``cfg.cache_dir`` after changing the data."""
    import hashlib
    import json

    payload = json.dumps([sorted(str(d) for d in cfg.data_dirs), cfg.min_phones,
                          cfg.max_phones, cfg.spkr_name_getter, cfg.max_num_val])
    digest = hashlib.sha256(payload.encode()).hexdigest()[:16]
    return Path(cfg.cache_dir) / f"datasets-{digest}.json"


def _datasets(cfg, train_paths, val_paths, phone_symmap=None, spkr_symmap=None,
              skip_validation=False, mesh=None):
    train_dataset = VALLEDataset(
        train_paths,
        cfg.get_spkr,
        phone_symmap=phone_symmap,
        spkr_symmap=spkr_symmap,
        min_phones=cfg.min_phones,
        max_phones=cfg.max_phones,
        training=True,
        p_additional_prompt=cfg.p_additional_prompt,
        max_prompts=cfg.max_prompts,
        seed=cfg.seed + _process_offset(mesh),
        skip_validation=skip_validation,
    )
    val_dataset = VALLEDataset(
        val_paths,
        cfg.get_spkr,
        phone_symmap=train_dataset.phone_symmap,
        spkr_symmap=train_dataset.spkr_symmap,
        min_phones=cfg.min_phones,
        max_phones=cfg.max_phones,
        p_additional_prompt=cfg.p_additional_prompt,
        max_prompts=cfg.max_prompts,
        extra_paths_by_spkr_name=train_dataset.paths_by_spkr_name,
        skip_validation=skip_validation,
    )
    val_dataset.interleaved_reorder_(cfg.get_spkr)
    val_dataset.head_(cfg.max_num_val)
    return train_dataset, val_dataset


def create_datasets(cfg, mesh=None):
    """Train and val datasets from ``cfg.data_dirs`` (≡ ``data.py:244-263``).
    With ``cfg.cache_dataloader`` the discovery, phone validation and
    symmaps are written to ``_dataset_cache_file(cfg)`` (JSON, as the JAX
    package writes it) and read back on later runs."""
    import json

    cache_file = _dataset_cache_file(cfg) if cfg.cache_dataloader else None
    if cache_file is not None and cache_file.exists():
        blob = json.loads(cache_file.read_text())
        _logger.info(f"Dataset construction restored from {cache_file}")
        return _datasets(cfg, [Path(p) for p in blob["train_paths"]],
                         [Path(p) for p in blob["val_paths"]], blob["phone_symmap"],
                         blob["spkr_symmap"], skip_validation=True, mesh=mesh)

    train_dataset, val_dataset = _datasets(cfg, *load_train_val_paths(cfg.data_dirs,
                                                                      cfg.get_spkr), mesh=mesh)
    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        cache_file.write_text(json.dumps(dict(
            train_paths=[str(p) for p in train_dataset.paths],
            val_paths=[str(p) for p in val_dataset.paths],
            phone_symmap=train_dataset.phone_symmap,
            spkr_symmap=train_dataset.spkr_symmap,
        )))
        _logger.info(f"Dataset construction cached to {cache_file}")
    return train_dataset, val_dataset


def _process_offset(mesh=None) -> int:
    """Offsets the training draw seed: this rank's dp coordinate on a mesh
    (a tp row loads one stream), else its global rank (0 in a world of
    one)."""
    return mesh.dp.rank if mesh is not None else global_rank()


def local_batch_size(batch_size: int, mesh=None) -> int:
    """A rank's rows of the global ``batch_size`` on the mesh's dp axis."""
    dp = 1 if mesh is None else mesh.shape["dp"]
    if batch_size % dp:
        raise ValueError(f"batch_size {batch_size} is not divisible by the dp mesh axis ({dp}); "
                         f"pick a batch_size that is a multiple of dp")
    return batch_size // dp


def create_train_val_dataloader(cfg, bucket: BucketSpec | None = None, mesh=None):
    """≡ ``data.py:266-285``: returns (train_dl, subtrain_dl, val_dl).  On a
    mesh ``cfg.batch_size`` is the global batch: the first rank of each tp
    row loads ``batch_size // dp`` rows from a stream seeded with its dp
    coordinate and broadcasts them over the row (``TensorParallelRowLoader``);
    the eval loaders are whole on every rank."""
    import copy

    bucket = bucket or BucketSpec(cfg.max_text_len, cfg.max_prom_len, cfg.max_resp_len)
    train_dataset, val_dataset = create_datasets(cfg, mesh)
    rows = local_batch_size(cfg.batch_size, mesh)
    tp_row = mesh is not None and mesh.tp.size > 1
    loads = not tp_row or mesh.tp.rank == 0

    train_dl = None
    if loads and cfg.use_native_loader:
        # the JAX package's two reasons to take the Python loader: a dataset
        # without .qnt.npy files, and no g++
        from .native_loader import NativeDataLoader, NoCompiler

        try:
            train_dl = NativeDataLoader(train_dataset, rows, bucket,
                                        n_workers=max(1, min(cfg.nj, 4)),
                                        seed=cfg.seed + _process_offset(mesh) * 7919)
        except (FileNotFoundError, NoCompiler) as e:
            _logger.info(f"Native loader unavailable ({e}); using the Python loader")
    if loads and train_dl is None:
        train_dl = DataLoader(train_dataset, rows, bucket, training=True, nj=cfg.nj)
    resp_buckets = getattr(cfg, "resp_len_buckets", None)
    if loads and resp_buckets:
        train_dl = LengthBucketedLoader(
            train_dl, bucket, resp_buckets,
            prom_buckets=getattr(cfg, "prom_len_buckets", None),
            window=getattr(cfg, "bucket_window_batches", 8),
            seed=cfg.seed, dp=None if mesh is None else mesh.dp,
        )
        _logger.info(
            "Length-bucketed batching: resp %s prom %s window %s",
            train_dl.resp_buckets, train_dl.prom_buckets, train_dl.window,
        )
    if tp_row:
        kind = broadcast_object(train_dl.kind if loads else None, mesh.rank - mesh.tp.rank,
                                mesh.tp.group)
        train_dl = TensorParallelRowLoader(train_dl, train_dataset, kind, mesh)
    _logger.info(f"Training batches from the {train_dl.kind} loader")
    val_dl = DataLoader(val_dataset, cfg.eval_batch_size, bucket, training=False)

    _logger.info(str(train_dataset.phone_symmap))
    _logger.info(str(train_dataset.spkr_symmap))
    _logger.info(f"#samples (train): {len(train_dataset)}.")
    _logger.info(f"#samples (val): {len(val_dataset)}.")

    subtrain_dataset = copy.copy(train_dataset)
    subtrain_dataset.rng = random.Random(cfg.seed + 1234)
    subtrain_dataset.paths = _interleaved_reorder(
        list(train_dataset.paths), cfg.get_spkr
    )
    subtrain_dataset.head_(cfg.max_num_val)
    subtrain_dataset.training_(False)
    subtrain_dl = DataLoader(
        subtrain_dataset, cfg.eval_batch_size, bucket, training=False
    )
    return train_dl, subtrain_dl, val_dl

