"""The port's host allocator tuning (`vsc22_tpu_torch/utils/hostmem.py`).

The JAX package tunes glibc when it is imported; the port only where a
command-line entry point starts. Whether the tuning is on is read from
glibc itself: with mmap off for malloc (M_MMAP_MAX=0), a 64 MiB block
comes from the brk heap, below `sbrk(0)`; by default glibc maps it apart.
Each check runs in a fresh interpreter, whose allocator nothing else has
touched.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

CLIS = (
    "vsc22_tpu_torch.pipelines.query_cli",
    "vsc22_tpu_torch.pipelines.ref_cli",
    "vsc22_tpu_torch.pipelines.ensemble_cli",
    "vsc22_tpu_torch.pipelines.matching_cli",
    "vsc22_tpu_torch.pipelines.descriptor_eval",
    "vsc22_tpu_torch.pipelines.preprocess",
    "vsc22_tpu_torch.train.descriptor_cli",
    "vsc22_tpu_torch.train.matching_cli",
)

PROBE = """
import ctypes
libc = ctypes.CDLL(None)
libc.malloc.restype = ctypes.c_void_p
libc.malloc.argtypes = [ctypes.c_size_t]
libc.free.argtypes = [ctypes.c_void_p]
libc.sbrk.restype = ctypes.c_void_p
libc.sbrk.argtypes = [ctypes.c_ssize_t]

def tuned():
    p = libc.malloc(64 << 20)
    below_brk = p < libc.sbrk(0)
    libc.free(p)
    return below_brk
"""


def run(code: str, opt_out: bool = False) -> str:
    env = {k: v for k, v in os.environ.items() if k != "VSC22_NO_MALLOC_TUNE"}
    if opt_out:
        env["VSC22_NO_MALLOC_TUNE"] = "1"
    out = subprocess.run([sys.executable, "-c", PROBE + code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_importing_the_port_leaves_the_allocator_alone():
    """The package and every CLI module imported: glibc as it was; then
    the first call tunes it and the second is a no-op that says so."""
    code = (
        "import importlib, vsc22_tpu_torch\n"
        f"for name in {CLIS + ('vsc22_tpu_torch.pipelines.clip_features',)!r}:\n"
        "    importlib.import_module(name)\n"
        "from vsc22_tpu_torch.utils import hostmem\n"
        "print(tuned(), hostmem._done)\n"
        "print(hostmem.tune_host_allocator(), tuned(), hostmem.tune_host_allocator(), tuned())\n"
    )
    assert run(code) == ["False", "False", "True", "True", "True", "True"]


def test_opt_out_is_honoured():
    code = (
        "from vsc22_tpu_torch.utils import hostmem\n"
        "print(hostmem.tune_host_allocator(), hostmem._done, tuned())\n"
    )
    assert run(code, opt_out=True) == ["False", "False", "False"]


class _Tuned(Exception):
    pass


def _spy():
    raise _Tuned


@pytest.mark.parametrize("name", CLIS)
def test_each_cli_tunes_first_thing(name, monkeypatch):
    """`main()` calls it before anything else, before its arguments are
    even parsed (none are given here)."""
    cli = importlib.import_module(name)
    monkeypatch.setattr(cli, "tune_host_allocator", _spy)
    with pytest.raises(_Tuned):
        cli.main([])


def test_clip_features_tunes_first_thing(monkeypatch, tmp_path):
    """`clip_features` has no `main()`: its entry point,
    `extract_clip_features`, tunes before it reads a video."""
    from vsc22_tpu_torch.pipelines import clip_features

    monkeypatch.setattr(clip_features, "tune_host_allocator", _spy)
    with pytest.raises(_Tuned):
        clip_features.extract_clip_features(iter(()), None, str(tmp_path / "feats.zip"))
