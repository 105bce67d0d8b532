"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, where the
hash covers that source, every ``csrc/*.cuh`` header and the compiler
flags, so an edited source is rebuilt and an unchanged one is reused. The
sources have a plain C interface and include no PyTorch header, so a build
takes seconds. Building happens at first use (or through ``build()``),
never at import: the CPU tests import every module without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("expert_chain", "fused_dispatch", "expert_chain_bwd",
           "fused_dispatch_bwd", "ragged_chain", "ragged_chain_bwd",
           "embedding_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library that is missing, one nvcc per source, all
    started together. Returns {name: seconds} for the ones compiled; the
    compiler's report (registers, shared memory, spills) is kept beside each
    library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in names:
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            jobs[name] = (proc, tmp, target, time.perf_counter())
        seconds = {}
        for name, (proc, tmp, target, t0) in jobs.items():
            out, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            target.with_suffix(".log").write_bytes(out)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu:\n{out.decode(errors='replace')}")
            os.replace(tmp, target)
        return seconds
    finally:
        for proc, tmp, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def load(name: str, prototypes: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing.

    prototypes: {function: (restype, [argtypes])}, declared once at load.
    """
    lib = _LIBS.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            build((name,))
        lib = ctypes.CDLL(str(target))
        for fn_name, (restype, argtypes) in prototypes.items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIBS[name] = lib
    return lib
