"""Build and load the port's CUDA kernels: every ``csrc/*.cu`` compiled by its
own ``nvcc``, all started together, and linked into ONE shared library with a
plain C interface, loaded with ctypes.

The library is built at first use into ``build/varnet_tpu_torch/<source hash>/``
(git-ignored) and reused while the sources and flags are unchanged; a measurement
build (``defines``: preprocessor macros such as ``csrc/ff_mlp.cu``'s ``FF_PHASE_CLOCK``)
gets a directory of its own.  The build
log, with ptxas' register and spill report for every kernel, sits beside it
(``build.log``).  Each ``ops`` module declares the C signatures of its own
entry points on the shared handle.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "varnet_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libvarnet_kernels.so"


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _flags(defines: tuple) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def source_hash(defines: tuple = ()) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return h.hexdigest()[:16]


def build_dir(defines: tuple = ()) -> Path:
    return BUILD_DIR / source_hash(defines)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "varnet_tpu_torch/csrc at first use")


@functools.lru_cache(maxsize=None)
def load_library(defines: tuple = ()) -> ctypes.CDLL:
    """Build every ``csrc/*.cu`` (once per source hash and ``defines``) and load
    the library.  ``load_library.build_seconds`` is the nvcc time of this process's
    last build (0.0 when the library was already built)."""
    out_dir = build_dir(defines)
    lib_path = out_dir / LIB_NAME
    load_library.build_seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *_flags(defines), "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = out_dir / f"{LIB_NAME}.{tag}"
        link = None
        if all(proc.returncode == 0 for proc in procs):
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
        load_library.build_seconds = time.perf_counter() - t0
        log = "\n".join(logs)
        (out_dir / "build.log").write_text(log)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))


load_library.build_seconds = 0.0


def raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")
