"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles, at first use, into its own shared library
with a plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a
-shared`). The library lands in `vsc22_tpu_torch/_build/`, named by a
digest of the sources and flags, so an edited source rebuilds and an
unchanged one loads in milliseconds. Nothing builds at import time: the
CPU tests import every module and never reach `library`.

Wrappers pass tensors as raw device pointers and PyTorch's current stream;
each C entry point returns `cudaGetLastError()` after its launches, and
`call` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return str(path)


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed.
    Different libraries may build at once, from several threads."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            path = BUILD_DIR / f"{name}-{_digest(name)}.so"
            if not path.exists():
                _compile(name, path)
            lib = ctypes.CDLL(str(path))
            lib.vsc22_error_string.argtypes = [ctypes.c_int]
            lib.vsc22_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for `name`."""
    return (BUILD_DIR / f"{name}-{_digest(name)}.log").read_text()


def call(lib_name: str, fn_name: str, argtypes: list, *args) -> None:
    """Call a C entry point that returns a cudaError_t; raise if it is not 0."""
    lib = library(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        msg = lib.vsc22_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc} ({msg})")


# ctypes argument types shared by the wrappers.
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype,
               shape: tuple) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def working_dtype(t: torch.Tensor) -> int:
    """The C dtype code of `t`; raise for types the kernels do not take."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def require_cuda(t: torch.Tensor) -> torch.device:
    """The device of a tensor the kernel path was handed; CUDA or raise."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return t.device
