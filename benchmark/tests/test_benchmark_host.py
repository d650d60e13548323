"""The host allocator a serving mix asks for: large blocks from the heap, and
freed memory kept mapped, so a second answer of the same size faults nothing."""

import subprocess
import sys

from bench_tiny import BENCH

PROBE = """
import ctypes, sys
sys.path.insert(0, {bench!r})
import numpy as np
from harness.host import keep_freed_memory

class Info(ctypes.Structure):  # glibc's struct mallinfo2
    _fields_ = [(n, ctypes.c_size_t) for n in
                ("arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
                 "fsmblks", "uordblks", "fordblks", "keepcost")]

info = ctypes.CDLL(None).mallinfo2
info.restype = Info
assert keep_freed_memory()
start = info()
a = np.ones(200 << 20, np.uint8)
held = info()
del a
freed = info()
print(held.hblkhd - start.hblkhd, held.uordblks - start.uordblks, held.arena, freed.arena)
"""


def test_large_blocks_come_from_the_heap_and_stay_mapped():
    out = subprocess.run([sys.executable, "-c", PROBE.format(bench=str(BENCH))],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    mapped, used, held, kept = map(int, out.split())
    assert mapped == 0              # no new block served by its own mmap
    assert used >= 200 << 20        # the 200 MB block lies in the heap
    assert kept == held             # and the heap keeps it once it is freed
