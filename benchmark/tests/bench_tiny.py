"""Tiny sizes of each cell, for the benchmark's CPU tests."""

from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

# Widths cut so a step takes well under a second on the CPU; the shapes'
# roles (the skips, the horizon, the pairs of request sizes) are kept.
TINY = {
    "mnist_dcgan.train_f32": (
        dict(enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=32, code_size_s=16,
             code_size_t=4, batch_size=4),
        dict(digits=50, traced_steps=2)),
    "mnist_dcgan.serve_f32": (
        dict(enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=32, code_size_s=16,
             code_size_t=4),
        dict(digits=50, batch=4, horizon=6, max_rows=4, pool_windows=16, sample=3,
             sample_from=6, warmup_rows=[4, 1], traced_requests=4)),
    "sst.train_f32": (
        dict(zone_size=16, code_size_s=8, code_size_t=4, res_hidden_size=16, batch_size=2),
        dict(zones=3, days=40, size=16, windows_per_zone=20, traced_steps=2)),
}


def tiny_job(name, seed=2**31 + 11, seconds=0.5, trace=False, bench=BENCH):
    """The cell's job on the CPU with its tiny sizes in place of the cell's."""
    import torch

    from harness import manifest
    from harness.job import Job

    cell = manifest.find_cell(name, bench)
    config, traffic = TINY.get(name, ({}, {}))
    return Job(cell, seed, seconds, trace, torch.device("cpu"), {**cell.config, **config},
               {**cell.traffic, **traffic})
