"""Build and load the hand-written CUDA kernels of ``bigdl_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with :mod:`ctypes` —
seconds per kernel, where a PyTorch C++ extension takes minutes. Builds
happen at first use (or up front through :func:`build`, which runs one
``nvcc`` per source in parallel), from the sources in this package only,
into ``bigdl_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags, so an edited kernel is rebuilt and an unchanged one is
not. Nothing here runs at import time: this module imports on a machine
without ``nvcc`` or a card, as the CPU tests do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The C entry point of each library and its ctypes signature.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "flash_attention": ("bigdl_flash_attention_fwd",
                        [_P, _P, _P, _P, _L, _L, _L, _L, _P,
                         _I, _I, _I, _I, _I, _F, _I, _I, _I, _P]),
    "paged_attention": ("bigdl_paged_attention",
                        [_P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _F, _I, _I, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, object] = {}   # process-wide: one dlopen per library


@dataclass
class BuildResult:
    name: str
    path: Path
    ptxas: str            # nvcc's -Xptxas -v report (registers, smem, spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "bigdl_tpu_torch need the CUDA toolkit to build")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _paths(name: str):
    stem = BUILD_DIR / f"{name}-{_digest(name)}"
    return stem.with_suffix(".so"), stem.with_suffix(".log")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, BuildResult]:
    """Compile every named kernel library that is missing (default: all of
    them), one ``nvcc`` process per source, all started together. Raises
    ``RuntimeError`` with the compiler output if any build fails."""
    names = list(SIGNATURES if names is None else names)
    with _lock:
        return _build_locked(names)


def _build_locked(names) -> Dict[str, BuildResult]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    for name in names:
        if name not in SIGNATURES:
            raise KeyError(f"unknown kernel library {name!r}")
        so, log = _paths(name)
        if so.exists():
            results[name] = BuildResult(
                name, so, log.read_text() if log.exists() else "")
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so, log)
    failures = []
    for name, (proc, tmp, so, log) in running.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                            f"{output}")
            continue
        log.write_text(output)
        os.replace(tmp, so)   # atomic: a reader never sees half a library
        results[name] = BuildResult(name, so, output)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return results


def entry(name: str):
    """The C launch function of kernel library ``name`` (``argtypes`` and
    ``restype`` declared), building and loading the library on first use."""
    fn = _loaded.get(name)
    if fn is None:
        with _lock:
            fn = _loaded.get(name)
            if fn is None:
                lib = ctypes.CDLL(str(_build_locked([name])[name].path))
                fn_name, argtypes = SIGNATURES[name]
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _loaded[name] = fn   # the function keeps its library loaded
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (0 is success)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
