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

`host_library` builds the one host library, `csrc/<name>.cpp` (plain C++
for the CPU: the alignment methods' sequential fills), with g++ in the
same way and into the same directory. It raises where g++ is missing or
fails: no caller has another version to fall back to.
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
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

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


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host library cannot be built here")
    return found


def _digest(flags: tuple, sources: list) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _cuda_digest(name: str) -> str:
    return _digest(NVCC_FLAGS, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])


def _compile(cmd: list, src: Path, out: Path) -> None:
    """Run `cmd` (a compiler and its flags) on `src` into `out`: the
    output goes to a file of this process's own and is renamed into place,
    so that processes building the same library at once each load a whole
    file."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [*cmd, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed for {src.name}:\n{log}")
    os.replace(tmp, out)


def _load(name: str, path_of, build) -> ctypes.CDLL:
    """The loaded library `name` at `path_of()`, built by `build(path)`
    first if the file is not there. Different libraries may build at once,
    from several threads."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            path = path_of()
            if not path.exists():
                build(path)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    src = CSRC / f"{name}.cu"
    return _load(name, lambda: BUILD_DIR / f"{name}-{_cuda_digest(name)}.so",
                 lambda path: _compile([_nvcc(), *NVCC_FLAGS], src, path))


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library of `csrc/<name>.cpp`, built with g++ first
    if needed; raises if it cannot be built."""
    src = CSRC / f"{name}.cpp"
    return _load(name, lambda: BUILD_DIR / f"{name}-{_digest(GXX_FLAGS, [src])}.so",
                 lambda path: _compile([_gxx(), *GXX_FLAGS], src, path))


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for `name`."""
    return (BUILD_DIR / f"{name}-{_cuda_digest(name)}.log").read_text()


def call(lib_name: str, fn_name: str, argtypes: list, *args) -> None:
    """Call a C entry point that returns a cudaError_t; raise if it is not 0."""
    lib = library(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        err = lib.vsc22_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        msg = err(rc).decode()
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
