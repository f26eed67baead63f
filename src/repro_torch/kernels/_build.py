"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source compiles into its own shared library with a plain C
interface under ``build/kernels/`` at the repo root, named by a hash of the
source, the headers (``*.cuh``) beside it and the flags, so an edited source
or header rebuilds and an unchanged one is reused.  Nothing builds at
import: the first launch builds.  A missing ``nvcc`` or a failed build
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}
# ptxas's report of each build (registers, shared memory, spills per kernel)
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(source: Path) -> Path:
    """Compile ``source`` into its hashed shared library (if not built yet)
    and return the library's path."""
    build_all([source])
    return library_path(source)


def build_all(sources: Iterable[Path]) -> None:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together; raises after all have finished if any failed."""
    todo = list({library_path(s): s for s in sources
                 if not library_path(s).exists()}.values())
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for source in todo:
        tmp = library_path(source).with_suffix(f".{os.getpid()}.tmp")
        procs.append((source, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for source, tmp, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {source}:\n"
                          f"{out}\n{err}")
            continue
        os.replace(tmp, library_path(source))
        BUILD_SECONDS[source.stem] = time.perf_counter() - t0
        BUILD_LOGS[source.stem] = err
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: Path) -> ctypes.CDLL:
    """Build (at first use) and ``ctypes``-load one kernel source."""
    key = str(source)
    with _LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LOADED[key] = lib
        return lib
