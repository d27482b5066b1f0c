"""Builds the port's CUDA sources with ``nvcc`` into shared libraries with a
plain C interface, loaded through ``ctypes``.

A library is built on first use into ``build/vipe_tpu_torch/`` at the
checkout root, named by a hash of its source, so an edited source rebuilds
and an unchanged one loads at once.  Nothing here runs at import time."""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "vipe_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for ``csrc/<name>.cu`` into a temporary file; None if
    the hashed library already exists."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> pathlib.Path:
    if job is None:
        return library_path(name)
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    return _finish(name, _start(name))


def build_all() -> list:
    """Compile every ``csrc/*.cu``, one ``nvcc`` per source, all started
    together.  Returns the library paths."""
    names = sorted(p.stem for p in _CSRC.glob("*.cu"))
    jobs = [_start(n) for n in names]
    paths, errors = [], []
    for n, j in zip(names, jobs):  # reap every nvcc before raising
        try:
            paths.append(_finish(n, j))
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
