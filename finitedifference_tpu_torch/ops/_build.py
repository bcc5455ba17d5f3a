"""Build the package's CUDA sources into one shared library at first use.

The sources under finitedifference_tpu_torch/csrc/ have a plain C
interface (no PyTorch headers, so a build takes seconds). Each *.cu is
compiled by its own nvcc process, all started together, and the objects
are linked into one shared library loaded with ctypes. The library goes
to finitedifference_tpu_torch/_build/, named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is not;
the compilers' register and shared-memory report (-Xptxas -v) is kept
beside it as <library>.ptxas.txt. Nothing is built when the package is
imported: only load_library() builds, and only a caller with a CUDA
tensor reaches it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libfd_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    Raises RuntimeError with nvcc's stderr if a compile or the link
    fails; every nvcc process started has ended when it returns."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in _sources():
            cmd = [nvcc, *COMPILE_FLAGS, "-o", str(tmp / f"{src.stem}.o"),
                   str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        reports, failures = [], []
        for cmd, proc in jobs:
            _, err = proc.communicate()
            reports.append(f"$ {' '.join(cmd)}\n{err}")
            if proc.returncode != 0:
                failures.append(f"nvcc failed with exit code "
                                f"{proc.returncode}: {' '.join(cmd)}\n{err}")
        if failures:
            raise RuntimeError("\n".join(failures))
        lib = tmp / "lib.so"
        cmd = [nvcc, *LINK_FLAGS, "-o", str(lib),
               *(str(tmp / f"{src.stem}.o") for src in _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code "
                               f"{proc.returncode}: {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text("\n".join(reports))
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    return ctypes.CDLL(str(build()))


def symbol(name: str, argtypes) -> ctypes._CFuncPtr:
    """The library's C function `name`, returning an int error code."""
    fn = getattr(load_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


# the C entry points' name suffix and scalar type for each working dtype
SCALARS = {torch.float32: ("f32", ctypes.c_float),
           torch.float64: ("f64", ctypes.c_double)}


def check_tensor(name, x, device, dtype, shapes) -> None:
    """Raise unless x is a contiguous CUDA tensor on `device` of `dtype`
    whose shape is one of `shapes`."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{getattr(x, 'device', type(x))}")
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: all inputs must share one device and "
                         f"dtype ({device}, {dtype}), got ({x.device}, "
                         f"{x.dtype})")
    if tuple(x.shape) not in shapes:
        raise ValueError(f"{name}: expected shape "
                         f"{' or '.join(map(str, shapes))}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_launch(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        lib = load_library()
        lib.fd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fd_cuda_error_string.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.fd_cuda_error_string(rc).decode()} "
                           f"(cudaError {rc})")
