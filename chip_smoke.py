"""Chip smoke test of the PyTorch/CUDA port: builds its kernels, holds each
against its plain PyTorch version on the card, serves the full-width
Moving-MNIST DCGAN forecaster through them, and trains it at the flagship
config of ``bench.py``.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

The rollout has two kernels, chosen per call by ``rollout_plan`` from the
shapes: the cluster kernel (weights resident in a thread-block cluster's
shared memory) and the streaming kernel (weights streamed from L2, for
weights no cluster can hold).  Phases (any failure exits nonzero, and no
result line is printed):

1. device: a CUDA card must be present; prints nvidia-smi's name and power limit;
2. build: every ``csrc/*.cu`` with nvcc, one process each, all at once;
   prints ptxas's report and whether it shows register spills;
3. kernels against plain: ``mlp_resnet_rollout`` against
   ``mlp_resnet_rollout_reference`` on the card, TF32 off, per step and
   relative, each case through the kernel its plan names: the serving
   shapes (B 64, code 20, H 512, 1 block, 100 steps; the cluster kernel at
   C 8, and the streaming kernel forced), B 13 with 2 blocks (C 16), B 13 at
   H 516 (C 8, a ragged hidden slice) and 4 blocks at H 512 (streaming);
4. serving, two paths, each with the launch counts set to 0 just before it
   and read just after:
   a. the main path: ``Forecaster(batch_size=64, n_forecast=100)`` on the
      full-width model built from seed 0 answers 64-, 17- and 1-window
      requests through the cluster kernel (3 launches of it, none of the
      streaming one); shapes, range, the padded answers against the full one
      (within tolerance with cuDNN's default algorithms, bitwise with
      ``cudnn.deterministic``), and the forecast against the same model with
      the plain rollout;
   b. the same model with a 4-block integrator (``n_blocks=4``) answers the
      same requests through the streaming kernel (3 launches of it, none of
      the cluster one); shapes, range, and its T codes against the plain
      rollout;
5. timing: the Forecaster's latency and per-layer profile; both kernels at
   the serving shapes, in turns (stream, cluster, cluster, stream); the
   cluster kernel at 4 rows a cluster; the plain loop, the eager
   ``torch.addmm`` loop and the bound;
6. the train step, card against CPU: full width, f32 with TF32 off, B 8,
   5+10 frames, offset 5, ``fused_loss``; the same weights, batch and
   ``t_random`` through ``make_train_step`` on the card and on the CPU.
   The loss terms, the gradients, the BatchNorm running statistics and the
   params after Adam must agree within the tolerances below, and the train
   step launches the rollout kernel 0 times (training differentiates
   through the integrator module; the kernel is forward-only);
7. the flagship train step (``bench.py:72-80``: B 128, bf16 compute, f32
   params, f32 BatchNorm IO, ``fused_loss``) on a fixed synthetic batch of
   moving squares made with numpy from a seed: 40 steps with a finite loss
   that falls, params and BatchNorm statistics that move, and no rollout
   launch; then the trained weights, served under ``mixed`` (bf16 serving
   is refused), answer one request through the cluster kernel (1 launch).
   Timing: 5 warm-up and 50 timed steps, bf16 and f32 with TF32 off,
   ms/step and samples/s; one step split by CUDA events into forward,
   backward and optimizer; a torch.profiler trace (top device kernels, the
   device's idle share); the step's FLOPs counted by
   ``torch.utils.flop_counter`` and their share of the card's bf16 peak.

The line before the last is a JSON object with one entry per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet
from spatiotemporal_variable_separation_tpu_torch.ops import _build
from spatiotemporal_variable_separation_tpu_torch.ops.rollout import (
    cluster_library,
    mlp_resnet_rollout,
    mlp_resnet_rollout_reference,
    rollout_plan,
)
from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster
from spatiotemporal_variable_separation_tpu_torch.train import (
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
)

B, N_FORECAST = 64, 100
REQUESTS = (64, 17, 1)  # windows per request: full, padded, single
# Kernel against plain, per step and relative to max |t_k| at that step: T
# grows ~1.2x a step at random init (to ~1e7-1e9 by step 99), so absolute
# error is the wrong measure.  Both are f32 sums in another order; an f32
# against f64 rollout on the CPU drifts 2.8e-6 at these shapes.
ROLLOUT_REL_TOL = 1e-4
# Two forecasts that should agree (through the kernel against the plain
# rollout; a padded request against the full one): a ~1e-6 relative
# difference -- the rollout's sum order, or the atomics of cuDNN's default
# transposed convs -- meets |T| ~1e7 in the late steps, where the decoder's
# sigmoid turns it into visible error on a few pixels near its midpoint.
# Measured: the same 64-window request twice on an H100, mean 1.4e-8, max
# 6.3e-3, 6.1e-7 of the pixels off by more than 1e-3; an f32 against an f64
# rollout on the CPU, mean 1.2e-7, max 5.3e-3, 8.5e-6 off by more than 1e-3.
FRAME_MEAN_TOL = 1e-5
FRAME_OFF_FRAC_TOL = 1e-4  # share of pixels allowed off by more than 1e-3

# Published peaks (NVIDIA data sheets; f32 outside the tensor cores, HBM).
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60.0e12, 3.9e12)}
PEAK_SXM = (66.9e12, 3.35e12)
# Dense bf16 tensor-core peaks, same data sheets (without sparsity).
BF16_PEAKS = {"PCIe": 756e12, "NVL": 835e12}
BF16_PEAK_SXM = 989e12

# -- phase 6: the train step on the card against the CPU ------------------
TRAIN_CHECK_B, TRAIN_CHECK_T_RANDOM = 8, 7
# Loss terms: f32 on both sides, sums in other orders (cuDNN against oneDNN);
# an f32 against f64 step on the CPU at these shapes differs by 1e-7.
TRAIN_LOSS_RTOL = 1e-4
# Gradients, max |card - CPU| over a tensor relative to the max |g| of its
# layer (weight and bias together: a conv bias that feeds a train-mode
# BatchNorm has zero gradient in exact arithmetic, so both sides return
# rounding noise there).  Not tighter: the two sides' activations differ by
# ~1e-6, and a LeakyReLU input that close to zero takes the other branch on
# one side, which moves the gradients of every layer before it by up to a
# few percent (tests/test_torch_losses.py measures it against f64).  An
# f32 against f64 step on the CPU at these shapes differs by 3.2e-2, in
# decoder.first_upconv.conv.weight.
TRAIN_GRAD_TOL = 0.1
# BatchNorm running statistics, relative to each layer's max |stat|: forward
# values, f32 sums of up to 65,536 terms in other orders; f32 against f64 on
# the CPU at these shapes: 4.9e-7.
TRAIN_STATS_TOL = 1e-4

# -- phase 7: the flagship train step --------------------------------------
FLAGSHIP = dict(data="mnist", architecture="dcgan", code_size_s=128, code_size_t=20,
                enc_hidden_size=64, dec_hidden_size=64, res_hidden_size=512, n_blocks=1,
                nt_cond=5, nt_pred=10, offset=5, batch_size=128, precision="bf16", seed=0,
                fused_loss=True)  # bench.py:72-80
TRAIN_STEPS, WARMUP_STEPS, TIMED_STEPS = 40, 5, 50
# The loss after TRAIN_STEPS steps on one fixed batch, against the first
# step's: 0.0306 measured on an H100 (129.7 -> 3.97); 0.1 leaves 3x room
# for cuDNN's run-to-run atomics and the bf16 roundings.
LOSS_FALL = 0.1


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def check_frames(out: np.ndarray, ref: np.ndarray, what: str) -> None:
    diff = np.abs(out - ref)
    off = float((diff > 1e-3).mean())
    print(f"{what}: mean abs {diff.mean():.3e} (tolerance {FRAME_MEAN_TOL:g}), max abs "
          f"{diff.max():.3e}, share off by >1e-3 {off:.3e} (tolerance {FRAME_OFF_FRAC_TOL:g})")
    check(diff.mean() <= FRAME_MEAN_TOL and off <= FRAME_OFF_FRAC_TOL, what)


def reset_launch_counts() -> None:
    mlp_resnet_rollout.launches = 0
    mlp_resnet_rollout.variant_launches = dict.fromkeys(mlp_resnet_rollout.variant_launches, 0)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def step_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max_k max|out_k - ref_k| / max|ref_k| over steps k."""
    diff = (out.double() - ref.double()).abs().amax(dim=(1, 2))
    scale = ref.double().abs().amax(dim=(1, 2)).clamp_min(1e-30)
    return float((diff / scale).max())


def cuda_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median device time of one ``fn()`` call, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def addmm_loop(t0, params, n_steps, out, h1, h2, res):
    """Eager ``torch.addmm`` rollout into preallocated buffers: the library
    yardstick (not one call; no single PyTorch call computes this function)."""
    out[0].copy_(t0)
    for k in range(1, n_steps):
        t = out[k - 1]
        for i in range(0, len(params), 6):
            w1, b1, w2, b2, w3, b3 = params[i:i + 6]
            torch.addmm(b1, t, w1, out=h1).relu_()
            torch.addmm(b2, h1, w2, out=h2).relu_()
            torch.addmm(b3, h2, w3, out=res)
            torch.add(t, res, out=out[k])
            t = out[k]
    return out


def profile_layers(model, cond: torch.Tensor, n_forecast: int) -> None:
    """One forecast with its layers called one by one: device time per layer
    from CUDA events at the layer boundaries; then a torch.profiler trace of
    another such forecast for the busiest kernels and the device's busy share
    of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def forecast_by_layer():
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        start = time.perf_counter()
        marks[0].record()
        s_code = model.encode_s(cond)
        marks[1].record()
        t_code = model.encode_t(cond)
        marks[2].record()
        t_codes, _ = model._integrate(t_code, n_forecast)
        marks[3].record()
        model._decode_all(s_code, None, t_codes)
        marks[4].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        return wall_ms, [marks[i].elapsed_time(marks[i + 1]) for i in range(4)]

    with torch.inference_mode():
        forecast_by_layer()  # warm-up
        wall_ms, layer_ms = forecast_by_layer()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_wall_ms, _ = forecast_by_layer()
    print(f"  one forecast, layer by layer: wall {wall_ms:.3f} ms")
    for name, ms in zip(("encode_s", "encode_t", "rollout", "decode"), layer_ms):
        print(f"    {name:9s} {ms:9.3f} ms ({ms / wall_ms:.1%} of the wall)")
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  traced forecast: wall {traced_wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / traced_wall_ms:.1%}), idle {1 - busy_ms / traced_wall_ms:.1%}")
    for e in kernels[:8]:
        print(f"    kernel {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5d} {e.key[:90]}")


def rollout_cost(batch, code, hidden, n_blocks, n_steps):
    """(operations, bytes) of one rollout: matmul multiply-adds, bias adds,
    relus and residual adds; each input read once, the output written once."""
    per_row = 2 * (code * hidden + hidden * hidden + hidden * code) + 4 * hidden + 2 * code
    ops = batch * per_row * n_blocks * (n_steps - 1)
    weights = n_blocks * (2 * code * hidden + hidden * hidden + 2 * hidden + code)
    nbytes = 4 * (batch * code + weights + n_steps * batch * code)
    return ops, nbytes


def moving_squares(batch: int, n_frames: int, seed: int) -> np.ndarray:
    """(batch, n_frames, 64, 64, 1) f32 frames of two 14-pixel squares that
    move at constant speed and bounce off the edges: a fixed, structured
    batch in Moving MNIST's shapes (the digit pipeline is a later slice)."""
    side, size = 14, 64
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, size - side, (batch, 2, 2))
    vel = rng.uniform(-3, 3, (batch, 2, 2))
    grid = np.arange(size)
    frames = np.zeros((batch, n_frames, size, size, 1), np.float32)
    for t in range(n_frames):
        for k in range(2):
            rows = (grid >= pos[:, k, :1]) & (grid < pos[:, k, :1] + side)
            cols = (grid >= pos[:, k, 1:]) & (grid < pos[:, k, 1:] + side)
            frames[:, t, :, :, 0] = np.maximum(frames[:, t, :, :, 0],
                                               rows[:, :, None] & cols[:, None, :])
        pos += vel
        out = (pos < 0) | (pos > size - side)
        vel[out] = -vel[out]
        pos = np.clip(pos, 0, size - side)
    return frames


def layer_rel_err(ours: dict, ref: dict) -> tuple:
    """(name, max over tensors of max |ours - ref| / max |ref| of its layer)."""
    scale = {}
    for n, r in ref.items():
        layer = n.rpartition(".")[0]
        scale[layer] = max(scale.get(layer, 0.0), float(r.abs().max()))
    errs = {n: float((ours[n] - r).abs().max()) / max(scale[n.rpartition(".")[0]], 1e-30)
            for n, r in ref.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def bn_stats(model) -> dict:
    return {f"{n}.{k}": getattr(m, k).detach().double().cpu()
            for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)
            for k in ("running_mean", "running_var")}


def train_step_card_vs_cpu(dev) -> None:
    """Phase 6: one f32 train step on the card and on the CPU from the same
    weights, batch and t_random."""
    cfg = ExperimentConfig(data="mnist", architecture="dcgan", precision="f32",
                           fused_loss=True, batch_size=TRAIN_CHECK_B)
    seq = moving_squares(TRAIN_CHECK_B, cfg.nt_cond + cfg.nt_pred, seed=6)
    cpu_model = build_separable_network(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    dev_model = copy.deepcopy(cpu_model).to(dev)
    results = {}
    for name, model, device in (("cpu", cpu_model, torch.device("cpu")), ("card", dev_model, dev)):
        opt = make_optimizer(model.parameters(), cfg, steps_per_epoch=100)
        state = TrainState(model=model, optimizer=opt, generator=torch.Generator())
        x = torch.from_numpy(seq).to(device)
        reset_launch_counts()
        metrics = make_train_step(model, cfg, opt)(state, x[:, :cfg.nt_cond], x[:, cfg.nt_cond:],
                                                   t_random=TRAIN_CHECK_T_RANDOM)
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = dict(mlp_resnet_rollout.variant_launches)  # the card's: read last
        results[name] = ({k: float(v) for k, v in metrics.items()},
                         {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()},
                         bn_stats(model),
                         {n: p.detach().double().cpu() for n, p in model.named_parameters()})
    (m_cpu, g_cpu, s_cpu, p_cpu), (m_dev, g_dev, s_dev, p_dev) = results["cpu"], results["card"]
    print(f"train step, card against CPU (f32, TF32 off, B {TRAIN_CHECK_B}, full width, "
          f"t_random {TRAIN_CHECK_T_RANDOM}): rollout kernel launches in the step {launches}")
    check(launches == {"cluster": 0, "stream": 0}, "the train step launched the rollout kernel")
    for k in m_cpu:
        rel = abs(m_dev[k] - m_cpu[k]) / abs(m_cpu[k])
        print(f"  {k}: card {m_dev[k]:.6f}, CPU {m_cpu[k]:.6f}, relative {rel:.2e} "
              f"(tolerance {TRAIN_LOSS_RTOL:g})")
        check(np.isfinite(m_dev[k]) and rel <= TRAIN_LOSS_RTOL, f"train loss term {k}")
    worst, err = layer_rel_err(g_dev, g_cpu)
    print(f"  gradients: worst {err:.2e} of the layer's max |g| at {worst} "
          f"(tolerance {TRAIN_GRAD_TOL:g})")
    check(err <= TRAIN_GRAD_TOL, "train gradients, card against CPU")
    worst, err = layer_rel_err(s_dev, s_cpu)
    print(f"  BatchNorm running statistics: worst {err:.2e} of the layer's max at {worst} "
          f"(tolerance {TRAIN_STATS_TOL:g})")
    check(err <= TRAIN_STATS_TOL, "BatchNorm statistics, card against CPU")
    # Adam's first step moves a param by lr g / (|g| + eps), at most lr, and
    # turns the sign of a ~0 gradient's noise into +-lr: the two sides part
    # by at most 2 lr, plus the rounding of params of up to ~1 (1e-6).
    tol = 2 * cfg.lr + 1e-6
    moved = max(float((p_dev[n] - p_cpu[n]).abs().max()) for n in p_cpu)
    print(f"  params after Adam: max |card - CPU| {moved:.2e} (tolerance {tol:g})")
    check(moved <= tol, "params after Adam, card against CPU")


def time_train_steps(state, step, cond, target) -> float:
    """Mean ms of one train step over TIMED_STEPS after WARMUP_STEPS, fenced
    by torch.cuda.synchronize()."""
    for _ in range(WARMUP_STEPS):
        step(state, cond, target)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step(state, cond, target)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / TIMED_STEPS * 1e3


def split_train_step(state, cfg, cond, target, reps: int = 10) -> dict:
    """Median device ms of the forward (compute_losses), backward and
    optimizer parts of a train step, by CUDA events between them."""
    model, opt = state.model, state.optimizer
    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        loss, _ = model.compute_losses(cond, target, cfg.nt_cond + 2, cfg.offset, cfg.lamb_ae,
                                       cfg.lamb_s, cfg.effective_lamb_t, cfg.lamb_pred,
                                       cfg.average_tloss, lamb_s_norm=cfg.lamb_s_norm)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v)) for k, v in parts.items()}


def profile_train_steps(state, step, cond, target, n: int = 3) -> None:
    """A torch.profiler trace of ``n`` train steps: the busiest device
    kernels and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            step(state, cond, target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    # The optimizer's user annotation shows on the device timeline too; it
    # spans Adam's kernels and is not one.
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and not e.key.startswith("Optimizer.")),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"  traced {n} steps: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}; "
          f"{launches / n:.0f} device kernels a step")
    for e in kernels[:12]:
        print(f"    kernel {e.self_device_time_total / 1e3 / n:9.3f} ms a step "
              f"({e.self_device_time_total / 1e3 / busy_ms:.1%}) x{e.count // n:<5d} {e.key[:90]}")


def step_flops(state, cfg, cond, target) -> float:
    """FLOPs of one train step's forward and backward, counted op by op
    (convolutions and matrix products) by torch.utils.flop_counter."""
    from torch.utils.flop_counter import FlopCounterMode

    model = copy.deepcopy(state.model)
    with FlopCounterMode(display=False) as counter:
        loss, _ = model.compute_losses(cond, target, cfg.nt_cond + 2, cfg.offset, cfg.lamb_ae,
                                       cfg.lamb_s, cfg.effective_lamb_t, cfg.lamb_pred,
                                       cfg.average_tloss)
        loss.backward()
    return float(counter.get_total_flops())


def flagship_train(dev, smi: str, card: str) -> None:
    """Phase 7: the flagship config trains on a fixed batch, is timed, and
    its weights serve one request through the cluster kernel."""
    cfg = ExperimentConfig(**FLAGSHIP)
    state = create_train_state(cfg, steps_per_epoch=100, device=dev)
    step = make_train_step(state.model, cfg, state.optimizer)
    seq = torch.from_numpy(moving_squares(cfg.batch_size, cfg.nt_cond + cfg.nt_pred, seed=7)).to(dev)
    cond, target = seq[:, :cfg.nt_cond], seq[:, cfg.nt_cond:]
    params0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    stats0 = bn_stats(state.model)
    reset_launch_counts()
    losses = [float(step(state, cond, target)["loss"]) for _ in range(TRAIN_STEPS)]
    launches = dict(mlp_resnet_rollout.variant_launches)
    print(f"flagship train step (bench.py:72-80: B {cfg.batch_size}, bf16 compute, f32 params, "
          f"f32 BatchNorm IO, fused_loss), {TRAIN_STEPS} steps on one fixed batch: loss "
          + ", ".join(f"{v:.4f}" for v in losses[:5]) + " ... "
          + ", ".join(f"{v:.4f}" for v in losses[-3:]))
    print(f"  rollout kernel launches during training: {launches}")
    check(launches == {"cluster": 0, "stream": 0}, "training launched the rollout kernel")
    check(bool(np.isfinite(losses).all()), "non-finite flagship loss")
    print(f"  last/first loss {losses[-1] / losses[0]:.4f} (must be below {LOSS_FALL:g})")
    check(losses[-1] < LOSS_FALL * losses[0], "the flagship loss did not fall")
    p_moved = min(float((p.detach() - params0[n]).abs().max())
                  for n, p in state.model.named_parameters())
    s_moved = min(float((v - stats0[n]).abs().max()) for n, v in bn_stats(state.model).items())
    print(f"  every param tensor moved (least max |change| {p_moved:.3e}); every BatchNorm "
          f"statistic moved (least max |change| {s_moved:.3e})")
    check(p_moved > 0 and s_moved > 0, "params or BatchNorm statistics did not move")
    # bf16 serving is refused (its integrator would be bf16); the trained
    # weights serve under ``mixed``: bf16 convs, the f32 rollout kernel.
    mixed = ExperimentConfig(**{**FLAGSHIP, "precision": "mixed"})
    served = build_separable_network(mixed, dev, torch.Generator().manual_seed(0))
    served.load_state_dict(state.model.state_dict())
    fc = Forecaster(served, mixed, batch_size=B, n_forecast=N_FORECAST, device=dev)
    reset_launch_counts()
    frames = fc.predict(seq[:B, :cfg.nt_cond].cpu().numpy())
    launches = dict(mlp_resnet_rollout.variant_launches)
    print(f"  the trained weights served under mixed, B{B} x {N_FORECAST}: rollout kernel "
          f"launches {launches}, frames in [{frames.min():.3f}, {frames.max():.3f}]")
    check(launches == {"cluster": 1, "stream": 0}, "one cluster-kernel launch for the request")
    check(frames.shape == (B, N_FORECAST) + cfg.frame_shape and bool(np.isfinite(frames).all())
          and bool(((frames >= 0) & (frames <= 1)).all()), "trained-model forecast")

    print(f"timing the train step on {smi}")
    bf16_ms = time_train_steps(state, step, cond, target)
    print(f"  flagship bf16 B{cfg.batch_size}: {bf16_ms:.3f} ms/step, "
          f"{cfg.batch_size / bf16_ms * 1e3:.1f} samples/s ({WARMUP_STEPS} warm-up, mean of "
          f"{TIMED_STEPS} steps)")
    parts = split_train_step(state, cfg, cond, target)
    total = sum(parts.values())
    print("  one step by CUDA events (median of 10): " + ", ".join(
        f"{k} {v:.3f} ms ({v / total:.1%})" for k, v in parts.items()))
    profile_train_steps(state, step, cond, target)
    flops = step_flops(state, cfg, cond, target)
    peak = next((v for k, v in BF16_PEAKS.items() if k in card), BF16_PEAK_SXM)
    print(f"  FLOPs of one step (forward and backward, torch.utils.flop_counter): "
          f"{flops / 1e12:.4f} TFLOP = {flops / cfg.batch_size / 3 / 1e9:.3f} GFLOP forward a "
          f"sample if backward is twice forward; {flops / bf16_ms / 1e9:.1f} TFLOP/s, "
          f"{flops / bf16_ms / 1e9 / (peak / 1e12):.1%} of the {peak / 1e12:.0f} TFLOP/s "
          f"dense bf16 peak (NVIDIA H100 data sheet)")
    del state, step
    f32_cfg = ExperimentConfig(**{**FLAGSHIP, "precision": "f32"})
    f32_state = create_train_state(f32_cfg, steps_per_epoch=100, device=dev)
    f32_step = make_train_step(f32_state.model, f32_cfg, f32_state.optimizer)
    f32_ms = time_train_steps(f32_state, f32_step, cond, target)
    print(f"  the same step in f32, TF32 off: {f32_ms:.3f} ms/step, "
          f"{cfg.batch_size / f32_ms * 1e3:.1f} samples/s; bf16 is {f32_ms / bf16_ms:.2f}x as fast")
    parts = split_train_step(f32_state, f32_cfg, cond, target)
    total = sum(parts.values())
    print("  f32 step by CUDA events (median of 10): " + ", ".join(
        f"{k} {v:.3f} ms ({v / total:.1%})" for k, v in parts.items()))
    profile_train_steps(f32_state, f32_step, cond, target)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main() -> None:
    # -- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {card}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"TF32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    flops_peak, bw_peak = next((v for k, v in PEAKS.items() if k in card), PEAK_SXM)

    # -- 2. build ------------------------------------------------------
    t = time.perf_counter()
    libs = _build.build()
    print(f"build: {len(libs)} kernel(s) in {time.perf_counter() - t:.1f} s")
    for name, lib in libs.items():
        log = (lib.parent / "build.log").read_text().strip()
        print(f"  {name}: {lib}\n    " + log.replace("\n", "\n    "))
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"  {name}: ptxas reports " + ("no register spills" if not spills else
                                             "register spills: " + "; ".join(spills)))

    # -- 3. kernel against plain ---------------------------------------
    cfg = ExperimentConfig(data="mnist", architecture="dcgan", precision="f32")
    model = build_separable_network(cfg, dev, torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    cond = rng.random((B, cfg.nt_cond) + cfg.frame_shape, dtype=np.float32)
    cond_dev = torch.from_numpy(cond).to(dev)
    with torch.inference_mode():
        t0_main = model.encode_t(cond_dev).contiguous()
    params_main = model.t_resnet.flat_params()
    gen = torch.Generator().manual_seed(1)
    ragged = MLPResnet(20, 2, 512, generator=gen).to(dev)
    cases = {  # label: (t0, params, n_steps, the plan's (variant, cluster))
        "serving B64 code20 H512 1 block 100 steps": (
            t0_main, params_main, N_FORECAST, ("cluster", 8)),
        "ragged B13 code20 H512 2 blocks 100 steps": (
            torch.randn(13, 20, generator=gen).to(dev), ragged.flat_params(), N_FORECAST,
            ("cluster", 16)),
        "ragged slice B13 code20 H516 1 block 100 steps": (
            torch.randn(13, 20, generator=gen).to(dev),
            MLPResnet(20, 1, 516, generator=gen).to(dev).flat_params(), N_FORECAST,
            ("cluster", 8)),
        "4 blocks B64 code20 H512 100 steps": (
            torch.randn(B, 20, generator=gen).to(dev),
            MLPResnet(20, 4, 512, generator=gen).to(dev).flat_params(), N_FORECAST,
            ("stream", 1)),
    }
    cluster_lib = cluster_library()
    errors = {}
    for label, (t0, params, n, expected) in cases.items():
        batch, code = t0.shape
        hidden, n_blocks = params[0].shape[1], len(params) // 6
        plans = [rollout_plan(batch, code, hidden, n_blocks)]
        check((plans[0].variant, plans[0].cluster) == expected,
              f"plan {plans[0]} is not {expected} [{label}]")
        if label.startswith("serving"):
            plans.append(rollout_plan(batch, code, hidden, n_blocks, variant="stream"))
        ref = mlp_resnet_rollout_reference(t0, params, n)
        for plan in plans:
            if plan.variant == "cluster":
                c_smem = cluster_lib.mlp_resnet_rollout_cluster_smem_bytes(
                    code, hidden, n_blocks, plan.cluster, plan.rows)
                active = cluster_lib.mlp_resnet_rollout_cluster_max_active(
                    batch, code, hidden, n_blocks, plan.cluster, plan.rows)
                print(f"plan [{label}]: {plan}; the kernel's own layout {c_smem} bytes; "
                      f"at most {active} such clusters at once")
                check(c_smem == plan.smem_bytes, "plan and kernel disagree on shared memory")
                check(active >= 1, f"no cluster of the plan fits [{label}]")
            else:
                print(f"plan [{label}]: {plan}")
            out = mlp_resnet_rollout(t0, params, n, plan=plan)
            torch.cuda.synchronize()
            rel = step_rel_err(out, ref)
            abs_err = float((out - ref).abs().max())
            errors[label, plan.variant] = (rel, abs_err)
            print(f"{plan.variant} kernel vs plain [{label}]: worst step-relative error "
                  f"{rel:.3e} (tolerance {ROLLOUT_REL_TOL:g}), max abs error {abs_err:.3e} "
                  f"at max |t| {float(ref.abs().max()):.3e}")
            check(tuple(out.shape) == tuple(ref.shape) == (n,) + tuple(t0.shape),
                  "rollout shape")
            check(bool(torch.isfinite(out).all() and torch.isfinite(ref).all()),
                  f"non-finite rollout values [{label}]")
            check(rel <= ROLLOUT_REL_TOL, f"{plan.variant} kernel disagrees with plain [{label}]")
    check({v for _, v in errors} == {"cluster", "stream"}, "both variants checked")

    # -- 4a. serving: the main path ------------------------------------
    fc = Forecaster(model, cfg, batch_size=B, n_forecast=N_FORECAST, device=dev)
    reset_launch_counts()
    answers = {b: fc.predict(cond[:b]) for b in REQUESTS}
    launches = dict(mlp_resnet_rollout.variant_launches)
    print(f"serving: requests of {list(answers)} windows, rollout kernel launches {launches}")
    check(launches == {"cluster": len(answers), "stream": 0},
          "one cluster-kernel launch per request")
    for b, a in answers.items():
        check(a.shape == (b, N_FORECAST) + cfg.frame_shape, f"forecast shape for {b}")
        check(bool(np.isfinite(a).all()), f"non-finite forecast for {b}")
        check(bool(((a >= 0) & (a <= 1)).all()), f"sigmoid forecast outside [0, 1] for {b}")
        # cuDNN's default transposed-conv algorithms accumulate with atomics:
        # the same request twice differs in the last bits, so padded rows
        # are held to the frame tolerance here and to bitwise identity below.
        check_frames(a, answers[B][:b], f"padded {b}-window answer vs the {B}-window rows")
    torch.backends.cudnn.deterministic = True
    exact = {b: fc.predict(cond[:b]) for b in REQUESTS[:2]}
    torch.backends.cudnn.deterministic = False
    small = REQUESTS[1]
    identical = np.array_equal(exact[small], exact[B][:small])
    print(f"with cudnn.deterministic: {small}-window answer bitwise equal to the "
          f"{B}-window rows: {identical}")
    check(identical, "padded rows differ with deterministic algorithms")
    with torch.inference_mode():
        t_codes_kernel = model.get_forecast(cond_dev, N_FORECAST)[1].transpose(0, 1)
        t_codes_plain = mlp_resnet_rollout_reference(t0_main, params_main, N_FORECAST)
        frames_plain = model._decode_all(model.encode_s(cond_dev), None, t_codes_plain)
    rel = step_rel_err(t_codes_kernel, t_codes_plain)
    print(f"serving T codes vs plain rollout: step-relative {rel:.3e} "
          f"(tolerance {ROLLOUT_REL_TOL:g})")
    check(rel <= ROLLOUT_REL_TOL, "serving T codes disagree with the plain rollout")
    check_frames(answers[B], frames_plain.cpu().numpy(),
                 "forecast vs the plain-rollout forecast")

    # -- 4b. serving with a 4-block integrator: the streaming kernel -----
    cfg4 = ExperimentConfig(data="mnist", architecture="dcgan", precision="f32", n_blocks=4)
    model4 = build_separable_network(cfg4, dev, torch.Generator().manual_seed(0)).eval()
    fc4 = Forecaster(model4, cfg4, batch_size=B, n_forecast=N_FORECAST, device=dev)
    reset_launch_counts()
    answers4 = {b: fc4.predict(cond[:b]) for b in REQUESTS}
    launches4 = dict(mlp_resnet_rollout.variant_launches)
    print(f"serving, 4-block integrator: requests of {list(answers4)} windows, rollout "
          f"kernel launches {launches4}")
    check(launches4 == {"cluster": 0, "stream": len(answers4)},
          "one streaming-kernel launch per 4-block request")
    for b, a in answers4.items():
        check(a.shape == (b, N_FORECAST) + cfg.frame_shape, f"4-block forecast shape for {b}")
        check(bool(np.isfinite(a).all()), f"non-finite 4-block forecast for {b}")
        check(bool(((a >= 0) & (a <= 1)).all()), f"4-block forecast outside [0, 1] for {b}")
    with torch.inference_mode():
        t_codes4 = model4.get_forecast(cond_dev, N_FORECAST)[1].transpose(0, 1)
        t_codes4_plain = mlp_resnet_rollout_reference(
            model4.encode_t(cond_dev).contiguous(), model4.t_resnet.flat_params(), N_FORECAST)
    rel = step_rel_err(t_codes4, t_codes4_plain)
    print(f"4-block serving T codes vs plain rollout: step-relative {rel:.3e} "
          f"(tolerance {ROLLOUT_REL_TOL:g})")
    check(rel <= ROLLOUT_REL_TOL, "4-block serving T codes disagree with the plain rollout")

    # -- 5. timing -----------------------------------------------------
    print(f"timing on {smi} (TF32 off)")
    stats = fc.benchmark(n_iters=30, warmup=3)
    print(f"  Forecaster B{B} x {N_FORECAST}: p50 {stats['p50_ms']:.3f} ms, p99 "
          f"{stats['p99_ms']:.3f} ms, mean {stats['mean_ms']:.3f} ms, "
          f"{stats['frames_per_sec']:.1f} frames/s")
    profile_layers(model, cond_dev, N_FORECAST)
    code, hidden = t0_main.shape[1], params_main[0].shape[1]
    n_blocks = len(params_main) // 6
    out, h1, h2, res = (torch.empty(N_FORECAST, B, code, device=dev),
                        torch.empty(B, hidden, device=dev), torch.empty(B, hidden, device=dev),
                        torch.empty(B, code, device=dev))
    lib_out = addmm_loop(t0_main, params_main, N_FORECAST, out, h1, h2, res)
    check(step_rel_err(lib_out, t_codes_plain) <= ROLLOUT_REL_TOL, "addmm loop disagrees")
    plans = {"cluster": rollout_plan(B, code, hidden, n_blocks),
             "stream": rollout_plan(B, code, hidden, n_blocks, variant="stream")}
    runs = {v: [] for v in plans}
    for v in ("stream", "cluster", "cluster", "stream"):
        runs[v].append(cuda_ms(
            lambda: mlp_resnet_rollout(t0_main, params_main, N_FORECAST, plan=plans[v])))
    ms = {v: float(np.mean(t)) for v, t in runs.items()}
    rows4 = rollout_plan(B, code, hidden, n_blocks, rows=4)
    rows4_ms = cuda_ms(lambda: mlp_resnet_rollout(t0_main, params_main, N_FORECAST, plan=rows4))
    rows4_active = cluster_lib.mlp_resnet_rollout_cluster_max_active(
        B, code, hidden, n_blocks, rows4.cluster, rows4.rows)
    plain_ms = cuda_ms(lambda: mlp_resnet_rollout_reference(t0_main, params_main, N_FORECAST))
    addmm_ms = cuda_ms(lambda: addmm_loop(t0_main, params_main, N_FORECAST, out, h1, h2, res))
    ops, nbytes = rollout_cost(B, code, hidden, n_blocks, N_FORECAST)
    t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    for v, plan in plans.items():
        print(f"  {v} kernel {plan}: {ms[v]:.4f} ms (mean of two medians of CUDA-event "
              f"timings, {runs[v][0]:.4f} and {runs[v][1]:.4f}), "
              f"{ms[v] / (N_FORECAST - 1) * 1e3:.3f} us a step; {bound_ms / ms[v]:.1%} of "
              f"the bound")
    print(f"  the cluster kernel is {ms['stream'] / ms['cluster']:.2f}x as fast as the "
          f"streaming kernel")
    print(f"  cluster kernel at 4 rows a cluster {rows4}: {rows4_ms:.4f} ms "
          f"({-(-B // rows4.rows)} clusters, at most {rows4_active} at once)")
    print(f"  plain loop (mlp_resnet_rollout_reference): {plain_ms:.4f} ms")
    print(f"  eager torch.addmm loop into preallocated buffers (not one call; no single "
          f"PyTorch call computes this function, so library_ms is null): {addmm_ms:.4f} ms")
    print(f"  bound: {ops / 1e9:.3f} GFLOP at {flops_peak / 1e12:.1f} TFLOP/s f32 = "
          f"{t_ops:.4f} ms; {nbytes / 1e6:.3f} MB at {bw_peak / 1e12:.2f} TB/s = "
          f"{t_bytes:.4f} ms; bound {bound_ms:.4f} ms by {bound_by}")

    # -- 6. the train step, card against CPU -------------------------------
    train_step_card_vs_cpu(dev)

    # -- 7. the flagship train step ------------------------------------------
    flagship_train(dev, smi, card)

    sources = {"cluster": "mlp_resnet_rollout_cluster.cu", "stream": "mlp_resnet_rollout.cu"}
    paths = {"cluster": ("serving, 1-block integrator", launches["cluster"]),
             "stream": ("serving, 4-block integrator", launches4["stream"])}
    serving = "serving B64 code20 H512 1 block 100 steps"
    print(json.dumps({"kernels": [{
        "name": f"mlp_resnet_rollout[{v}]",
        "route": "cuda",
        "source": f"spatiotemporal_variable_separation_tpu_torch/csrc/{sources[v]}",
        "replaces": "spatiotemporal_variable_separation_tpu/ops/pallas/rollout.py:91",
        "launches": paths[v][1],
        "launches_path": paths[v][0],
        "max_abs_err": errors[serving, v][1],
        "max_step_rel_err": errors[serving, v][0],
        "ms": ms[v],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "addmm_loop_ms": addmm_ms,
        "shapes": "B 64, code 20, H 512, 1 block, 100 steps",
        "plan": plans[v]._asdict(),
    } for v in ("cluster", "stream")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
