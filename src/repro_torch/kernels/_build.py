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
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("prune_fixpoint", "pso_fitness", "fitness_quantized",
           "epoch_fused", "finish_fused", "pso_update", "ullmann_refine",
           "argmax_project")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
#: ``{(library object, entry name): bound entry}``. Keyed on the loaded
#: library and not on its stem, so that swapping ``_libs[stem]`` for
#: another build (``kernel_ab.py``) binds against the library swapped in.
_bound: Dict[Tuple[object, str], ctypes._CFuncPtr] = {}


class LaunchCounter:
    """Number of kernel launches a wrapper has made (and nothing else),
    and the number of wrapper calls that made them."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.calls = 0

    def add(self, k: int = 1) -> None:
        if k:
            self.count += k
            self.calls += 1

    def reset(self) -> None:
        self.count = 0
        self.calls = 0


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


def bind(name: str, fn: str, argtypes,
         restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """C entry ``fn`` of library ``name`` with its argument types set,
    looked up once per loaded library; a launching entry returns the
    ``cudaError_t`` of its launches."""
    lib = library(name)
    f = _bound.get((lib, fn))
    if f is None:
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = restype
        _bound[lib, fn] = f
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {err}")


def stream() -> int:
    """The raw handle of the current device's current CUDA stream, read
    without making a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


P_ = ctypes.c_void_p
I_ = ctypes.c_int
F_ = ctypes.c_float


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def mask_arg(x: torch.Tensor):
    """A 0/1 operand as the kernels take it: ``(contiguous tensor, 1 if
    int32 else 0)``; bool is read as its bytes, other dtypes become
    uint8 ``x != 0``."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    elif x.dtype not in (torch.uint8, torch.int32):
        x = (x != 0).to(torch.uint8)
    return x.contiguous(), int(x.dtype == torch.int32)
