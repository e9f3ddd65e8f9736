"""ctypes binding of the native C++ data loader ``native/dataloader.cc``
(counterpart of ``data/native_loader.py`` in the JAX package, with the same
C signatures and the same batches).

npy parsing, speaker-balanced sampling, prompt concatenation and padded
batch assembly run in C++ worker threads off the GIL, behind a bounded
prefetch queue.  Host code only: nothing here touches the device.

The library is built with ``g++`` at first use, never at import, into
``build/torch_kernels/`` beside the CUDA kernels, named by a hash of the
source and the flags (as ``ops/_build.py`` names the kernels), so an edited
source rebuilds and ``native/`` is never written.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR
from .dataset import BucketSpec, VALLEDataset, get_phones

_logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parents[2] / "native" / "dataloader.cc"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NoCompiler(RuntimeError):
    """There is no ``g++`` to build the library with."""


def library_path(src: Path = SRC) -> Path:
    """Where the library is built: named by a hash of the source and the flags."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libdataloader-{digest.hexdigest()[:12]}.so"


def build_library() -> Path:
    """Compile ``native/dataloader.cc`` with ``g++`` unless its library exists
    (``NoCompiler`` without ``g++``, RuntimeError when it fails)."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NoCompiler("g++ not found: the native loader cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *FLAGS, str(SRC), "-o", str(tmp)]
    _logger.info("Building the native loader: %s", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SRC.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The built library with every function's argument and result types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [ctypes.c_int64] * 6 + [ctypes.c_double, ctypes.c_uint64,
                                                         ctypes.c_int64]
        lib.dl_add_utterance.restype = None
        lib.dl_add_utterance.argtypes = [ctypes.c_void_p, ctypes.c_char_p, i32, ctypes.c_int64,
                                         ctypes.c_int32]
        lib.dl_start.restype = None
        lib.dl_start.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p, i32, f32, i32, f32, i32, f32, i64]
        lib.dl_destroy.restype = None
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        lib.dl_load_npy.restype = ctypes.c_int
        lib.dl_load_npy.argtypes = [ctypes.c_char_p, i32, ctypes.c_int64, i64, i64]
        _lib = lib
        return lib


def native_load_npy(path: str | Path) -> np.ndarray:
    """A 2-D int16/int32/int64 npy read by the C++ parser, as int32."""
    lib = load_library()
    cap = 64 * 1024 * 1024
    out = np.empty(cap, np.int32)
    rows, cols = np.zeros(1, np.int64), np.zeros(1, np.int64)
    rc = lib.dl_load_npy(str(path).encode(), out, cap, rows, cols)
    if rc != 0:
        raise IOError(f"native npy load failed ({rc}) for {path}")
    return out[: rows[0] * cols[0]].reshape(rows[0], cols[0]).copy()


class NativeDataLoader:
    """Infinite training loader backed by the C++ worker pool.  Only
    ``.qnt.npy`` artifacts are read (FileNotFoundError otherwise: a dataset
    of ``.qnt.pt`` files takes the Python loader).  With one worker and the
    same seed it yields the JAX package's batches."""

    kind = "native"

    def __init__(self, dataset: VALLEDataset, batch_size: int, bucket: BucketSpec,
                 n_workers: int = 2, seed: int = 0, queue_cap: int = 4):
        self.batch_size = batch_size
        self.bucket = bucket
        self.dataset = dataset
        self.paths = list(dataset.paths)
        npys = []
        for path in self.paths:
            npy = (path.parent / path.name.split(".")[0]).with_suffix(".qnt.npy")
            if not npy.exists():
                raise FileNotFoundError(f"NativeDataLoader requires .qnt.npy artifacts; "
                                        f"missing {npy}")
            npys.append(npy)
        lib = self._lib = load_library()
        self._handle = lib.dl_create(batch_size, bucket.text_len, bucket.prom_len,
                                     bucket.resp_len, bucket.n_levels, dataset.max_prompts,
                                     dataset.p_additional_prompt, seed, queue_cap)
        for path, npy in zip(self.paths, npys):
            phones = np.array([dataset.phone_symmap[p] for p in get_phones(path)], np.int32)
            spkr = dataset.spkr_symmap[dataset.get_spkr(path)]
            lib.dl_add_utterance(self._handle, str(npy).encode(), phones, len(phones), spkr)
        lib.dl_start(self._handle, n_workers)

    def __iter__(self):
        b, bk = self.batch_size, self.bucket
        while self._handle:
            text = np.empty((b, bk.text_len), np.int32)
            text_mask = np.empty((b, bk.text_len), np.float32)
            proms = np.empty((b, bk.prom_len, bk.n_levels), np.int32)
            prom_mask = np.empty((b, bk.prom_len), np.float32)
            resps = np.empty((b, bk.resp_len, bk.n_levels), np.int32)
            resp_mask = np.empty((b, bk.resp_len), np.float32)
            indices = np.empty((b,), np.int64)
            rc = self._lib.dl_next(self._handle, text.ravel(), text_mask.ravel(), proms.ravel(),
                                   prom_mask.ravel(), resps.ravel(), resp_mask.ravel(), indices)
            if rc != 0:
                return
            yield dict(
                path=[self.paths[i] for i in indices],
                spkr_name=[self.dataset.get_spkr(self.paths[i]) for i in indices],
                text=text,
                text_mask=text_mask,
                proms=proms,
                prom_mask=prom_mask,
                resps=resps,
                resp=resps[..., 0].copy(),
                resp_mask=resp_mask,
            )

    def close(self):
        """Stop and join the workers (idempotent)."""
        if self._handle:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()
