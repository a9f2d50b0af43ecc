"""Build the port's CUDA sources with ``nvcc`` on first use; load them with
``ctypes``.

Every ``kernels/*/csrc/*.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` into ``kernels/build/`` (git-ignored).
A library's file name carries a hash of its source, of every header
(``*.cuh``) in its ``csrc/`` directory and in the shared ``include/``
directory (on the include path of every build), and of the flags, so a
changed source or header rebuilds and an unchanged one loads as is.  All
missing libraries are compiled at once, one ``nvcc`` process per source,
started together.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"
INCLUDE_DIR = KERNELS_DIR / "include"   # headers shared between kernels
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v"] + ARCH_FLAGS

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_NVCC.exists():
        nvcc = str(CUDA_NVCC)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return nvcc


def library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in (sorted(src.parent.glob("*.cuh"))
                   + sorted(INCLUDE_DIR.glob("*.cuh"))):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def nvcc_command(nvcc: str, src: Path, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(out),
            str(src)]


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; returns stem -> path.

    nvcc's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, paths = [], {}
    for src in sources():
        out = library_path(src)
        paths[src.stem] = out
        if not out.exists():
            todo.append((src, out))
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, out, tmp, subprocess.Popen(
            nvcc_command(nvcc, src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                          f"{stderr}")
            continue
        Path(str(out) + ".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise KeyError(f"no kernel source named {stem}.cu")
            lib = _libs[stem] = ctypes.CDLL(str(paths[stem]))
        return lib


def build_log(stem: str) -> str:
    """nvcc's output for the built library of ``csrc/<stem>.cu``."""
    for src in sources():
        if src.stem == stem:
            log = Path(str(library_path(src)) + ".log")
            return log.read_text() if log.exists() else ""
    raise KeyError(stem)
