"""Build, load and count the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, at first use, and
loaded with ``ctypes``. The libraries live under ``_build/<hash>/`` next
to the package (``.gitignore`` lists it), keyed by a hash of every
source and of the compiler flags, so an edited source is rebuilt and an
unchanged one is not. ``build_all`` starts one ``nvcc`` per source at
once. Nothing here runs at import time: a machine without ``nvcc`` or a
card imports every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("prune_fixpoint", "pso_fitness", "epoch_fused", "finish_fused")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Number of kernel launches a wrapper has made (and nothing else)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self, k: int = 1) -> None:
        self.count += k

    def reset(self) -> None:
        self.count = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set CUDA_HOME)")


def _build_dir() -> Path:
    h = hashlib.sha1(repr(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _start(name: str, out_dir: Path):
    out = out_dir / f"lib{name}.so"
    tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library at once (one ``nvcc`` per source).
    Returns ``{name: ptxas report}`` for the sources compiled now; raises
    with nvcc's output if one fails."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"lib{n}.so").exists()]
    procs = [(n, *_start(n, out_dir)) for n in todo]
    reports, failed = {}, []
    for name, proc, tmp, out in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n"
                          f"{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)
        reports[name] = stderr
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _build_dir() / f"lib{name}.so"
        if not path.exists():
            build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``fn`` of library ``name`` with its argument types set;
    every entry returns the ``cudaError_t`` of its launch."""
    f = getattr(library(name), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {err}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


P_ = ctypes.c_void_p
I_ = ctypes.c_int
F_ = ctypes.c_float


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
