"""The host process's allocator, as a serving mix asks for it.

``Forecaster.predict`` hands back each answer in a new pageable array of up
to b x horizon frames (105 MB at 64 x 100 of 64x64 f32).  glibc serves a
block that large by a fresh ``mmap`` and unmaps it when it is freed, so every
request faults in its answer page by page while the copy back fills it; on
the card's machine that cost 1.0-1.5 ms a row and changed from process to
process by a third, so a request's time followed the host and not the
program.  A mix with ``keep_freed_host_memory`` runs its service as a
long-lived server is run: large blocks come from the heap and freed memory
stays mapped, so an answer reuses pages that are already there.
"""

from __future__ import annotations

import ctypes
import ctypes.util

M_TRIM_THRESHOLD = -1  # mallopt's parameter numbers, from glibc's malloc.h
M_MMAP_MAX = -4


def keep_freed_memory() -> bool:
    """Serve every block from the heap and never give freed memory back to
    the system.  False where the C library is not glibc."""
    name = ctypes.util.find_library("c")
    try:
        libc = ctypes.CDLL(name)
        mallopt = libc.mallopt
    except (OSError, AttributeError, TypeError):
        return False
    mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    return bool(mallopt(M_MMAP_MAX, 0)) and bool(mallopt(M_TRIM_THRESHOLD, 2**31 - 1))
