"""Serving latency at B 64 x 100 beside the rollout alone: the plain loop
against both rollout kernels.

The port's counterpart of the repository's ``tools/bench_serving_pallas.py``
(the port has no Pallas: its rollout kernels are CUDA).  Run::

    python -m spatiotemporal_variable_separation_tpu_torch.tools.bench_serving_rollout \
        [--device cpu] [--cfg JSON] [--batch 64] [--horizon 100] [--iters 30] \
        [--amortized_k 10]

At the flagship geometry (``bench.FLAGSHIP``), fresh weights from seed 0 and
one request of ``--batch`` windows drawn from seed 0, it measures:

1. ``serve.Forecaster`` end to end (one device fence a call, p50 and p99
   over ``--iters`` calls) in ``f32``, ``mixed`` and ``bf16``;
2. the same calls amortized: ``--amortized_k`` calls back to back and one
   fence, the median of ``AMORTIZED_REPS`` such runs, per call;
3. the plain rollout ``ops.rollout.mlp_resnet_rollout_reference`` of the
   f32 model's integrator from the request's T code, ``--horizon`` steps;
4. ``ops.rollout.mlp_resnet_rollout`` at the same signature, in the variant
   ``rollout_plan`` picks and in the streaming variant forced.

(3) and (4) are timed by CUDA events.  ``kernel_max_abs_err`` and
``kernel_max_step_rel_err`` hold each kernel against (3);
``rollout_share_of_serving`` is the planned kernel's ms over the f32 p50.
The bf16 forecast loops its bf16 integrator and launches no kernel.  One
JSON line, last, holds these with ``launches``, the kernel launches of the
whole run by variant.  Matmuls and convolutions run with TF32 off.  The
device is the card unless ``--device cpu`` is given; on the CPU the kernel
figures are null (a CPU tensor takes the plain version).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

BATCH, HORIZON = 64, 100
PRECISIONS = ("f32", "mixed", "bf16")
E2E_ITERS, WARMUP = 30, 5
AMORTIZED_K, AMORTIZED_REPS = 10, 3


def amortized_ms(fn, sync, k: int, reps: int = AMORTIZED_REPS, warmup: int = WARMUP) -> float:
    """ms a call of ``k`` calls back to back and one ``sync()``, the median
    of ``reps`` runs."""
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3 / k)
    return float(np.median(times))


def rollout_args(model, cond: torch.Tensor) -> tuple:
    """(t0, params) of the rollout ``model`` serves for ``cond``: the T
    code of the request and the integrator's flat f32 parameters."""
    with torch.inference_mode():
        t0 = model.encode_t(cond).float().contiguous()
    return t0, model.t_resnet.flat_params()


def step_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max over steps k of max|out_k - ref_k| / max|ref_k|."""
    diff = (out.double() - ref.double()).abs().amax(dim=(1, 2))
    scale = ref.double().abs().amax(dim=(1, 2)).clamp_min(1e-30)
    return float((diff / scale).max())


def main(argv=None) -> dict:
    from spatiotemporal_variable_separation_tpu_torch.bench import (
        add_arguments,
        cuda_ms,
        flagship_config,
        nvidia_smi,
        tf32_off,
    )
    from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device
    from spatiotemporal_variable_separation_tpu_torch.models.factory import (
        build_separable_network,
    )
    from spatiotemporal_variable_separation_tpu_torch.ops.rollout import (
        mlp_resnet_rollout,
        mlp_resnet_rollout_reference,
        rollout_plan,
        stream_active_clusters,
    )
    from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster

    p = argparse.ArgumentParser(
        prog="python -m spatiotemporal_variable_separation_tpu_torch.tools.bench_serving_rollout",
        description="Serving latency beside the rollout alone, plain and in both kernels.")
    add_arguments(p)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--horizon", type=int, default=HORIZON)
    p.add_argument("--iters", type=int, default=E2E_ITERS, help="end-to-end calls timed")
    p.add_argument("--amortized_k", type=int, default=AMORTIZED_K)
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device, "bench_serving_rollout")
    except RuntimeError as e:
        raise SystemExit(f"bench_serving_rollout: {e}") from e
    on_card = device.type == "cuda"
    card = torch.cuda.get_device_name(device) if on_card else "cpu"
    if on_card:
        print(f"bench_serving_rollout on {nvidia_smi()}", file=sys.stderr)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    start_launches = dict(mlp_resnet_rollout.variant_launches)
    base = flagship_config(args.cfg)
    rng = np.random.default_rng(0)
    request = rng.random((args.batch, base.nt_cond) + base.frame_shape, dtype=np.float32)
    cond = torch.from_numpy(request).to(device)
    e2e, amortized, serve_launches, models = {}, {}, {}, {}
    with tf32_off():
        for precision in PRECISIONS:
            cfg = dataclasses.replace(base, precision=precision).validate()
            model = build_separable_network(cfg, device, torch.Generator().manual_seed(0))
            fc = Forecaster(model, cfg, args.batch, args.horizon, device=device)
            before = dict(mlp_resnet_rollout.variant_launches)
            e2e[precision] = fc.benchmark(n_iters=args.iters, warmup=WARMUP)
            amortized[precision] = amortized_ms(lambda: fc.forecast(cond), sync,
                                                args.amortized_k)
            serve_launches[precision] = {v: n - before[v] for v, n in
                                         mlp_resnet_rollout.variant_launches.items()}
            models[precision] = fc.model

        t0, params = rollout_args(models["f32"], cond)
        plain = mlp_resnet_rollout_reference(t0, params, args.horizon)
        plain_ms = (cuda_ms(lambda: mlp_resnet_rollout_reference(t0, params, args.horizon))
                    if on_card else amortized_ms(
                        lambda: mlp_resnet_rollout_reference(t0, params, args.horizon),
                        sync, args.amortized_k))
        kernel = {}
        if on_card:
            batch, code = t0.shape
            hidden, n_blocks = params[0].shape[1], len(params) // 6
            active = stream_active_clusters(batch, code, hidden, n_blocks)
            for variant in ("planned", "stream"):
                plan = rollout_plan(batch, code, hidden, n_blocks, active_clusters=active,
                                    variant=None if variant == "planned" else variant)
                out = mlp_resnet_rollout(t0, params, args.horizon, plan=plan)
                kernel[variant] = {
                    "plan": plan._asdict(),
                    "ms": cuda_ms(lambda: mlp_resnet_rollout(t0, params, args.horizon,
                                                             plan=plan)),
                    "max_abs_err": float((out - plain).abs().max()),
                    "max_step_rel_err": step_rel_err(out, plain)}

    def by_variant(key):
        return {v: k[key] for v, k in kernel.items()} if on_card else None

    out = {
        "signature": f"batch {args.batch}, horizon {args.horizon}",
        "device": card,
        "serve_e2e_p50_ms": {k: v["p50_ms"] for k, v in e2e.items()},
        "serve_e2e_p99_ms": {k: v["p99_ms"] for k, v in e2e.items()},
        "serve_p50_ms": amortized,
        "frames_per_sec": {k: v["frames_per_sec"] for k, v in e2e.items()},
        "plain_rollout_ms": plain_ms,
        "kernel_rollout_ms": by_variant("ms"),
        "kernel_plan": by_variant("plan"),
        "kernel_vs_plain": ({v: k["ms"] / plain_ms for v, k in kernel.items()}
                            if on_card else None),
        "kernel_max_abs_err": by_variant("max_abs_err"),
        "kernel_max_step_rel_err": by_variant("max_step_rel_err"),
        "rollout_share_of_serving": (kernel["planned"]["ms"] / e2e["f32"]["p50_ms"]
                                     if on_card else None),
        "serve_launches": serve_launches,
        "launches": {v: n - start_launches[v]
                     for v, n in mlp_resnet_rollout.variant_launches.items()},
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
