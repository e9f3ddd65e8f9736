"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` is one plain-C shared library: no PyTorch
headers, so a build takes seconds, not minutes.  Libraries go to
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source and flags, so an edited source rebuilds and
an unchanged one is loaded as it is.  The build runs at first use, never at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", ARCH)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def compile_source(name: str, log=print) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; prints the build
    seconds and ptxas's register / shared-memory lines."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "smem" in ln or "spill" in ln]
    log(f"built {out.name} in {secs:.2f} s")
    for ln in lines:
        log(f"  ptxas: {ln}")
    return out


def build_all(names=None, log=print) -> dict[str, Path]:
    """Compile every source (or ``names``), one ``nvcc`` each, all started
    together."""
    names = list(names) if names is not None else sorted(
        p.stem for p in CSRC.glob("*.cu"))
    results: dict[str, Path] = {}
    errors: list[BaseException] = []

    def one(n):
        try:
            results[n] = compile_source(n, log)
        except BaseException as e:  # re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def load(name: str) -> ctypes.CDLL:
    """Compile if needed and ``ctypes``-load ``lib<name>``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name, log=_stderr)))
            _loaded[name] = lib
        return lib


def _stderr(msg: str):
    print(msg, file=sys.stderr, flush=True)
