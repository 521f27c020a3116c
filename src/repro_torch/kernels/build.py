"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). All missing libraries build at once, one ``nvcc`` process per
source, started together. A library's file name carries a digest of its
sources and flags, so an edited source never loads a stale build. Builds go
to ``_build/`` beside the package sources (listed in ``.gitignore``), with
the compiler's output — ``ptxas`` register and shared-memory use — in a
``.log`` beside each library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sketch_join", "rank_transform", "containment", "postings",
           "hash_build", "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
#: guards the wrappers' ``launches`` counts: kernels launch from several
#: threads (the async scheduler's workers), and a bare ``+=`` loses updates
LAUNCH_LOCK = threading.Lock()


def count_launch(fn) -> None:
    """Add one to the launch count of wrapper ``fn``."""
    with LAUNCH_LOCK:
        fn.launches += 1


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library of source ``name`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    raise with the compiler's output if any fails."""
    with _lock:
        todo = {s: library_path(s) for s in SOURCES
                if not library_path(s).exists()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            out.with_suffix(".log").write_bytes(log)
            if proc.returncode:
                errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        return {s: library_path(s) for s in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, building all sources first
    if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all()[name]))
        return _libs[name]


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name``."""
    return library_path(name).with_suffix(".log").read_text()
