"""Where a block-step of the port's rollout kernels spends its time.

Builds ``csrc/mlp_resnet_rollout_cluster.cu`` (weights resident in a cluster)
and ``csrc/mlp_resnet_rollout.cu`` (W2 streamed through a ring) with
``-DROLLOUT_PHASE_CLOCKS`` into ``build/phase_clocks/`` and runs them on the
card.  In that build thread 0 of CTA 0 adds the SM clocks it spends in each
phase of every block-step; the script prints them per block-step.  A phase
that ends in a barrier includes the wait for the slowest thread of the
cluster.  In the streaming kernel thread 0 also refills the ring slots of its
row group: its "ring refill" is the time to issue that bulk copy (after its
group's warps release the slot), and "ring wait" the wait for a copy to land.
Needs one NVIDIA H100 and the CUDA toolkit; from the root of a checkout::

    python3 tools/torch_rollout_phases.py

Cases, cluster kernel: the serving shapes (B 64, code 20, hidden 512, 1 block,
cluster 8, 8 rows), the same at cluster 16, and hidden 32 at clusters 8 and 1,
where the products are small and what is left is the fixed cost of each
phase.  Streaming kernel: the WaveEq eval's shape (B 256, code 32, hidden 512,
3 blocks, 45 steps) at its plan (cluster 8, 20 rows), the 4-block serving
shape (B 64, code 20, 100 steps) at its plan (cluster 16, 12 rows), and 8
blocks at code 64, hidden 512 (B 64, 30 steps) at its plan (cluster 16, 12
rows), where W1, the biases and W3 are read from L2, not resident.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet  # noqa: E402
from spatiotemporal_variable_separation_tpu_torch.ops import _build  # noqa: E402
from spatiotemporal_variable_separation_tpu_torch.ops.rollout import pack_w2  # noqa: E402

PHASES = {
    "mlp_resnet_rollout_cluster": (
        "h1 = relu(t W1 + b1)", "h1 to every rank", "cluster barrier 1", "W2 split-K",
        "W2 split-K sum", "W3 split-K and sum", "partials to every rank",
        "cluster barrier 2", "t update", "out[k] write (per step)"),
    "mlp_resnet_rollout": (
        "h1 = relu(t W1 + b1)", "h1 to every rank", "cluster barrier 1",
        "ring refill (thread 0)", "ring wait (bulk copy)", "W2 FMAs", "W2 split-K sum",
        "W3 split-K and sum", "partials to every rank", "cluster barrier 2", "t update",
        "out[k] write (per step)"),
}
CASES = [  # kernel, batch, code, hidden, n_blocks, cluster, rows, n_steps, resident
    ("mlp_resnet_rollout_cluster", 64, 20, 512, 1, 8, 8, 100, True),
    ("mlp_resnet_rollout_cluster", 64, 20, 512, 1, 16, 8, 100, True),
    ("mlp_resnet_rollout_cluster", 64, 20, 32, 1, 8, 8, 100, True),
    ("mlp_resnet_rollout_cluster", 64, 20, 32, 1, 1, 8, 100, True),
    ("mlp_resnet_rollout", 256, 32, 512, 3, 8, 20, 45, True),
    ("mlp_resnet_rollout", 64, 20, 512, 4, 16, 12, 100, True),
    ("mlp_resnet_rollout", 64, 64, 512, 8, 16, 12, 30, False),
]


def build(name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "phase_clocks" / f"lib{name}_phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DROLLOUT_PHASE_CLOCKS", "-o", str(out),
           str(_build.CSRC / f"{name}.cu")]
    subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "mlp_resnet_rollout":
        lib.mlp_resnet_rollout_f32.argtypes = [vp, vp, vp, i, vp, i, i, i, i, i, i, i, vp]
    else:
        lib.mlp_resnet_rollout_cluster_f32.argtypes = [vp, vp, i, vp, i, i, i, i, i, i, vp]
    getattr(lib, f"{name}_f32").restype = i
    clocks = getattr(lib, f"{name}_phase_clocks")
    clocks.argtypes, clocks.restype = [vp], i
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_rollout_phases: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    with ThreadPoolExecutor(len(PHASES)) as pool:  # one nvcc each, started together
        libs = dict(zip(PHASES, pool.map(build, PHASES)))
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    for name, batch, code, hidden, n_blocks, cluster, rows, n_steps, resident in CASES:
        lib, phases = libs[name], PHASES[name]
        clocks = (ctypes.c_ulonglong * len(phases))()
        getattr(lib, f"{name}_phase_clocks")(clocks)  # clear
        params = MLPResnet(code, n_blocks, hidden, generator=gen).to(dev).flat_params()
        t0 = torch.randn(batch, code, generator=gen).mul_(0.1).to(dev)
        out = torch.empty(n_steps, batch, code, device=dev)
        ptrs = (ctypes.c_void_p * len(params))(*(p.data_ptr() for p in params))
        args = (t0.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p))
        shape = (n_blocks, out.data_ptr(), batch, code, hidden, n_steps, cluster, rows)
        stream = torch.cuda.current_stream().cuda_stream
        if name == "mlp_resnet_rollout":
            w2 = pack_w2(params, cluster)
            err = lib.mlp_resnet_rollout_f32(*args, w2.data_ptr(), *shape, int(resident), stream)
        else:
            err = lib.mlp_resnet_rollout_cluster_f32(*args, *shape, stream)
        if err != 0:
            raise SystemExit(f"{name}: launch failed with code {err}")
        torch.cuda.synchronize()
        if getattr(lib, f"{name}_phase_clocks")(clocks) != 0:
            raise SystemExit("reading the phase clocks failed")
        steps = (n_steps - 1) * n_blocks
        per_step = [c / steps for c in clocks]
        print(f"{name}: B {batch}, code {code}, hidden {hidden}, {n_blocks} block(s), cluster "
              f"{cluster}, {rows} rows{'' if resident else ', W1/biases/W3 from L2'}: "
              f"{sum(per_step):.0f} clocks a block-step")
        for phase, c in zip(phases, per_step):
            print(f"  {phase:24s} {c:7.0f}")


if __name__ == "__main__":
    main()
