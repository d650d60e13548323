"""The benchmark's harness: the manifest and the files it names, the card,
the run of one cell, the profiler's trace and the comparison that decides
``correct``."""
