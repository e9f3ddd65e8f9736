"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` is one plain-C shared library: no PyTorch
headers, so a build takes seconds, not minutes.  Libraries go to
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source, the ``csrc/*.cuh`` headers it includes
(``csrc/hopper_attention.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged tree is loaded as it is.  The build runs at first
use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
#: ``-I`` flags (none: the sources include only the toolkit's headers and
#: their own ``csrc/*.cuh``); part of the library's hash
INCLUDES: tuple[str, ...] = ()
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

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


def local_headers(src: Path) -> list[Path]:
    """The quoted ``#include "..."`` files of ``src`` beside it, and theirs,
    each once, in the order first met."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop(0).read_bytes()):
            dep = src.parent / name.decode()
            if dep.is_file() and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``lib<name>`` is built: named by a hash of ``csrc/<name>.cu``,
    the headers it includes from ``csrc`` and the flags."""
    src = csrc / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for dep in local_headers(src):
        digest.update(dep.name.encode() + b"\0" + dep.read_bytes())
    digest.update(" ".join(FLAGS + INCLUDES).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def compile_source(name: str, log=print) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; prints the build
    seconds and ptxas's register / shared-memory lines."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, *INCLUDES, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "smem" in ln or "spill" in ln or "entry function" in ln]
    log(f"built {out.name} in {secs:.2f} s")
    for ln in lines:
        log(f"  ptxas: {ln}")
    return out


#: SASS opcodes of the Hopper path: wgmma and TMA tensor loads
SASS_OPCODES = ("HGMMA", "UTMALDG")
#: wgmma shapes (M x N x K) each library holds: the m64n64k16 products that
#: reduce over the head width, and the m64nDHk16 products whose output is
#: the head width, at each instantiated width (8, 16, 32, 64, 128, 256)
HGMMA_SHAPES = ("64x8x16", "64x16x16", "64x32x16", "64x64x16", "64x128x16", "64x256x16")


def sass_counts(lib: Path) -> dict[str, int] | str:
    """How many instructions of each of ``SASS_OPCODES``, and of HGMMA at
    each of ``HGMMA_SHAPES`` (as ``HGMMA.<shape>``), the built library's
    SASS holds (``cuobjdump -sass`` beside ``nvcc``), or why it cannot
    say."""
    tool = Path(nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        found = shutil.which("cuobjdump")
        if found is None:
            return f"cuobjdump not found beside {nvcc()} or on PATH"
        tool = Path(found)
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True)
    if proc.returncode != 0:
        return f"cuobjdump failed ({proc.returncode}): {proc.stderr.strip()[:200]}"
    counts = {op: len(re.findall(rf"\b{op}\b", proc.stdout)) for op in SASS_OPCODES}
    for shape in HGMMA_SHAPES:
        counts[f"HGMMA.{shape}"] = len(re.findall(rf"\bHGMMA\.{shape}\b", proc.stdout))
    return counts


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
