"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`. The
sources include no PyTorch headers, so a build takes seconds. Libraries
land in ``horovod_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name keyed by a hash of the source, the headers beside it and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. Nothing is built at import: the first launch builds, or
:func:`build` does it ahead of time, one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build made by this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> Optional[str]:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    location, or the first ``nvcc`` on ``PATH``; None when there is none."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    return shutil.which("nvcc")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives: keyed by its source, every header
    in ``csrc`` (any source may include one) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def available(name: str) -> bool:
    """True when ``name`` is loaded or built, or an ``nvcc`` can build it."""
    return (
        name in _loaded
        or library_path(name).exists()
        or nvcc_path() is not None
    )


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all running at once. Raises RuntimeError with
    the compiler's output when one fails."""
    todo: Dict[str, Tuple[Path, Path]] = {}
    out: Dict[str, Path] = {}
    for name in names:
        path = library_path(name)
        out[name] = path
        if not path.exists():
            todo[name] = (path, path.with_suffix(f".{os.getpid()}.tmp"))
    if not todo:
        return out
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {sorted(todo)}: no nvcc (set CUDA_HOME or put "
            "the CUDA toolkit's bin/ on PATH)"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {
        name: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name, (_, tmp) in todo.items()
    }
    failures = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        path, tmp = todo[name]
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        build_logs[name] = log
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed. ``declare``
    sets its functions' ``argtypes``/``restype`` once, at load."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            declare(lib)
            _loaded[name] = lib
        return lib
