"""Host allocator tuning for page-fault-bound virtual machines.

Counterpart of `vsc22_tpu/utils/hostmem.py`. On hosts where freshly mapped
pages fault in far slower than resident memory moves, glibc's habit of
returning every allocation above the mmap threshold to the kernel on free
makes each large numpy temp of the host pipeline (packed descriptor
matrices, FSD frame stacks, corpus generation) pay the fault-in again.

`tune_host_allocator()` makes glibc keep freed pages resident: malloc
stops using mmap (M_MMAP_MAX=0) and stops trimming the heap
(M_TRIM_THRESHOLD=max), so the arena warms up once and every later large
temp reuses pages already faulted in. A no-op off glibc. Opt out with
VSC22_NO_MALLOC_TUNE=1 (on hosts short of memory: freed pages stay
resident, so the resident size grows to the high-water mark).

The JAX package applies it when it is imported. The port does not: each
of its command-line entry points calls it first thing in `main()`, so the
processes that users run get it, and importing the library changes
nothing.
"""

from __future__ import annotations

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_MAX = -4

_done = False


def tune_host_allocator() -> bool:
    """Apply the glibc tuning once per process; returns True if applied."""
    global _done
    if _done:
        return True
    if os.environ.get("VSC22_NO_MALLOC_TUNE", "") == "1":
        return False
    try:
        libc = ctypes.CDLL(None)
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1))
        ok = bool(libc.mallopt(_M_MMAP_MAX, 0)) and ok
    except (OSError, AttributeError):
        return False
    _done = ok
    return ok
