"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, named after a hash of its
source, under ``_build/`` beside this file (listed in ``.gitignore``).
A library whose source has not changed is reused. :func:`build_all`
starts one ``nvcc`` per source, all at once.

:func:`load` and :func:`build_all` hold one lock, so two threads that
reach an unbuilt kernel together build it once and load it once. A
build also holds a file lock in the build directory, so that processes
(the ranks of :func:`repro_torch.compat.spawn`) that reach a stale
source together build it once: the others wait and find it built. Each
build writes to a temporary file of its own (process and thread) and
renames it into place.

A library loaded into the process is a compile event of the retrace
rule (:func:`repro_torch.analysis.retrace.note_compile`).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from repro_torch.analysis.retrace import note_compile

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("cd_solve", "hinge_scores", "gram", "sparse_gram",
           "cd_solve_gram", "flash_decode", "cd_solve_sparse")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.RLock()
#: ptxas report (registers, shared memory, spills) of each fresh build
PTXAS_REPORT: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _tmp_path(name: str) -> Path:
    """A build's temporary output, unique to this process and thread."""
    return library_path(name).with_suffix(
        f".{os.getpid()}-{threading.get_ident()}.tmp")


def build_all() -> float:
    """Compile every stale source in parallel; → seconds spent."""
    with _LOCK:
        if all(library_path(n).is_file() for n in SOURCES):
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)     # released on close
            return _build_stale()


def _build_stale() -> float:
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not library_path(n).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = _tmp_path(name)
        procs[name] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        PTXAS_REPORT[name] = out
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not library_path(name).is_file():
                build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
            note_compile(f"build:{name}")
        return lib
