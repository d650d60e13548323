"""Where a block-step of the port's cluster rollout kernel spends its time.

Builds ``csrc/mlp_resnet_rollout_cluster.cu`` with ``-DROLLOUT_PHASE_CLOCKS``
into ``build/phase_clocks/`` and runs it on the card.  In that build thread 0
of CTA 0 adds the SM clocks it spends in each phase of every block-step; the
script prints them per block-step.  A phase that ends in a barrier includes
the wait for the slowest thread of the cluster.  Needs one NVIDIA H100 and the
CUDA toolkit; from the root of a checkout::

    python3 tools/torch_rollout_phases.py

Cases: the serving shapes (B 64, code 20, hidden 512, 1 block, cluster 8,
8 rows), the same at cluster 16, and hidden 32 at clusters 8 and 1, where the
products are small and what is left is the fixed cost of each phase.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet  # noqa: E402
from spatiotemporal_variable_separation_tpu_torch.ops import _build  # noqa: E402

PHASES = ("h1 = relu(t W1 + b1)", "h1 to every rank", "cluster barrier 1", "W2 split-K",
          "W2 split-K sum", "W3 split-K and sum", "partials to every rank",
          "cluster barrier 2", "t update", "out[k] write (per step)")
CASES = [  # batch, code, hidden, n_blocks, cluster, rows, n_steps
    (64, 20, 512, 1, 8, 8, 100),
    (64, 20, 512, 1, 16, 8, 100),
    (64, 20, 32, 1, 8, 8, 100),
    (64, 20, 32, 1, 1, 8, 100),
]


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "phase_clocks" / "libmlp_resnet_rollout_cluster_phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DROLLOUT_PHASE_CLOCKS", "-o", str(out),
           str(_build.CSRC / "mlp_resnet_rollout_cluster.cu")]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.mlp_resnet_rollout_cluster_f32.argtypes = [vp, vp, i, vp, i, i, i, i, i, i, vp]
    lib.mlp_resnet_rollout_cluster_f32.restype = i
    lib.mlp_resnet_rollout_cluster_phase_clocks.argtypes = [vp]
    lib.mlp_resnet_rollout_cluster_phase_clocks.restype = i
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_rollout_phases: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    lib = build()
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(0)
    clocks = (ctypes.c_ulonglong * len(PHASES))()
    lib.mlp_resnet_rollout_cluster_phase_clocks(clocks)  # clear
    for batch, code, hidden, n_blocks, cluster, rows, n_steps in CASES:
        params = MLPResnet(code, n_blocks, hidden, generator=gen).to(dev).flat_params()
        t0 = torch.randn(batch, code, generator=gen).mul_(0.1).to(dev)
        out = torch.empty(n_steps, batch, code, device=dev)
        ptrs = (ctypes.c_void_p * len(params))(*(p.data_ptr() for p in params))
        err = lib.mlp_resnet_rollout_cluster_f32(
            t0.data_ptr(), ctypes.cast(ptrs, ctypes.c_void_p), n_blocks, out.data_ptr(),
            batch, code, hidden, n_steps, cluster, rows, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"launch failed with code {err}")
        torch.cuda.synchronize()
        if lib.mlp_resnet_rollout_cluster_phase_clocks(clocks) != 0:
            raise SystemExit("reading the phase clocks failed")
        steps = (n_steps - 1) * n_blocks
        per_step = [c / steps for c in clocks]
        print(f"B {batch}, code {code}, hidden {hidden}, {n_blocks} block(s), cluster "
              f"{cluster}, {rows} rows: {sum(per_step):.0f} clocks a block-step")
        for name, c in zip(PHASES, per_step):
            print(f"  {name:24s} {c:7.0f}")


if __name__ == "__main__":
    main()
