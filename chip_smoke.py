"""Chip smoke test of the PyTorch/CUDA port: builds its kernels, holds each
against its plain PyTorch version on the card, serves the full-width
Moving-MNIST DCGAN forecaster through them, trains it at the flagship
config of ``bench.py`` and scores it with both Moving MNIST protocols; then
generates WaveEq on the card, trains both WaveEq recipes and scores them;
then writes the 3D Chairs stand-in corpus, trains the chairs recipe and
scores its content swap; then makes the TaxiBJ and SST stand-ins in memory,
trains both recipes and scores them, then writes both as their HDF5 files
and trains and scores them from there; then trains the ``--no_s`` ablation,
probes the rollout's stability (``diagnose``, ``--monitor_stability``) and
drives the operations tooling; then trains data- and tensor-parallel and
evaluates and serves over a mesh, as far as one card can show; then runs
the port's benchmark and measurement tools; then imports a reference
experiment, serves it and exports it back; then holds the decoder's
transposed-conv kernel against its plain version and cuDNN at the serving
and an Evaluator's shapes.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py            # every phase, in order
    python3 chip_smoke.py 9 19       # these phases, and the products they read

A phase is named by its label below ("12-13" runs TaxiBJ and SST as one).
The phases share one working directory and the products a later phase reads
(``PRODUCTS``: which phase makes each and which read it), each built by one
function at its first use and then kept.  A phase asked for alone builds what
it reads, and runs with it the checks of the phase that builds it: ``9``
runs 8b's.

The rollout has two kernels, chosen per call by ``rollout_plan`` from the
shapes: the cluster kernel (weights resident in a thread-block cluster's
shared memory) and the streaming kernel (the same column split over a
cluster, each CTA's W2 slices streamed from L2 through a ring of TMA bulk
copies, for weights no resident cluster can hold).  Phases (any failure exits nonzero, and no
result line is printed):

1. device: a CUDA card must be present; prints nvidia-smi's name and power limit;
2. build: every ``csrc/*.cu`` with nvcc, one process each, all at once;
   prints ptxas's report and whether it shows register spills;
3. kernels against plain: ``mlp_resnet_rollout`` against
   ``mlp_resnet_rollout_reference`` on the card, TF32 off, per step and
   relative, each case through the kernel its plan names: the serving
   shapes (B 64, code 20, H 512, 1 block, 100 steps; the cluster kernel at
   C 8, and the streaming kernel forced: its ring wraps on one slice), B 13
   with 2 blocks (C 16), B 13 at H 516 (C 8, a ragged hidden slice; and the
   streaming kernel forced), 4 blocks at H 512 (streaming), the WaveEq
   eval's shape (B 256 x 45 steps, code 32, H 512, 3 blocks; streaming) and
   a ragged B 250 of it, 16 blocks at H 256 (the kernels' limit; streaming,
   30 steps), 8 blocks at code 64, H 512 and at code 20, H 2048 (streaming
   with W1, the biases and W3 read from L2: no cluster holds their slices
   beside the ring; 30 and 20 steps, B 64 and a ragged B 50), and phase 11a's
   chairs shapes (code 10, H 512, 1 block at B 16
   x 15 and B 64 x 100; C 8, and the streaming kernel forced); for each
   plan, the kernel's own shared-memory layout against the plan's and the
   clusters that fit at once;
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
5. kernel timing, through ``rollout_turns``, the one procedure that times
   the rollout kernels (each plan held against the plain version, then
   timed in turns with the plain loop and the eager ``torch.addmm`` loop,
   beside the bound): both kernels and the cluster kernel at 4 rows a
   cluster at the serving shapes; the streaming kernel at the 4-block
   serving shape and at 8 blocks of code 64 (W1, biases and W3 from L2);
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
   launch; then the trained weights, served under ``mixed`` (bf16 convs,
   the f32 rollout), answer one request through the cluster kernel (1 launch).
   Then the bf16 step's ms/step and samples/s (3 warm-up and 20 timed
   steps), which no benchmark cell measures (the cells are f32);
8. the train entry point at the flagship config, on synthetic idx digits
   (60,000, MNIST's training size) written to a temporary directory:
   a. data on the card: one flagship batch (B 128, 2 digits, 15 frames)
      drawn and rendered on the card, and rendered from the same draws on
      the CPU, bitwise equal (and equal to the host ``composite``); the same
      for the stochastic bounce solver, positions and counts;
   b. ``cli.main.main`` in-process at ``bench.py``'s flags, 2 epochs x 20
      steps: checkpoints ``1``, ``2`` and ``final``, ``metrics.csv`` rows, a
      finite loss that falls, no rollout launch; samples/s an epoch; the
      checkpoint saved and restored bitwise;
   c. resume with ``cudnn.deterministic``: 2 epochs x 6 steps uninterrupted,
      against the same run stopped by a SIGTERM that its ``log_fn`` sends
      after step 8 and resumed; params, BatchNorm statistics, Adam moments
      and the logged loss strings bitwise equal;
   d. the host path (``--no-device_datagen --num_workers 4``), one epoch of
      4 steps, samples/s beside 8b's, and the host generator's time a batch;
   e. ``Forecaster.from_xp_dir(xp, 64, 100, precision="mixed")`` on 8b's
      checkpoint answers a 64-window request through the cluster kernel (1
      launch), within the frame tolerances of a Forecaster over 8b's model;
9. the Moving MNIST evaluation, on 1,000 synthetic test digits written as
   idx files beside 8's training digits, and the test set ``make_test_set``
   makes of them (500 sequences of 100 frames; the reference protocol has
   5,000), at the eval batch of 16:
   a. SSIM on the card with TF32 at torch's global default, 240 frames of
      64x64x1 and 60 of 64x64x3, against the CPU in f32 and in f64 (a plain
      f64 SSIM written out here); every value at most 1.  Beside it, the same
      moments by a one-group cuDNN convolution with TF32 allowed: what the
      guard in ``ops/ssim.py`` prevents;
   b. ``Evaluator.score`` of one B 16 nt_pred-10 batch on the card and on the
      CPU (the full-width seed-0 model of phase 3, f32, TF32 off): per-sequence
      MSE, PSNR and SSIM within the tolerances below; exactly 1 launch of the
      cluster kernel at its B 16 plan (C 8, 2 clusters); the kernel against
      its plain version at B 16 x 100 steps;
   c. the protocols through their CLIs, in-process, on 8b's bf16 checkpoint:
      ``cli.test_mnist`` and ``cli.test_mnist_disentanglement`` at nt_pred 10
      on all 500 sequences, ``cli.test_mnist`` at nt_pred 95 cut to
      ``T95_MAX_BATCHES`` batches, archives capped at ``ARCHIVE_CAP``: finite
      means, SSIM in (0, 1], the ``evals.json`` records, and 0 rollout
      launches (the bf16 path loops its integrator); the t95 forecast's SSIM
      step by step (from its archive) beside each step's share of pixels at
      0 or 1.  Then the same
      protocols through ``evaluate(model_bundle=...)`` on the f32 seed-0
      model, cut to ``BUNDLE_MAX_BATCHES``: one cluster launch for each
      kernel-bearing call (a score, or an archived batch's swap forecast);
   d. the t10 eval of the checkpoint killed after batch 2 and resumed, under
      ``cudnn.deterministic``: means bitwise equal to the uninterrupted run;
   e. per protocol, the scoring loop's sequences/s and the device's idle
      share under the profiler, for the bf16 checkpoint and the f32 model;
      both kernels at the t10 eval's rollout shapes (B 16 x 15 steps).
10. WaveEq and WaveEq-100 (the recipes of ``tests/test_recipes.py:28-36``,
    full width), in a temporary directory:
    a. ``simulate_wave`` on the card, 2 sequences x 300 steps of 64x64, both
       tableaus, against the port on the CPU and against an f64 numpy RK4,
       the error relative to each frame's max;
    b. ``generate_dataset`` on the card at the canonical size (300 sequences
       x 300 frames, seed 42, ~1.5 GB of npz) and ``generate_pixels``: the
       seconds, and the f0/c draws byte-equal to a host ``RandomState(42)``;
    c. ``DeviceWaveEq`` over the train split on the card: a B 128 batch of
       the same draws gathered on the card and on the CPU, bitwise; the
       corpus's MB on the card;
    d. the train CLI on both recipes in bf16, 2 epochs x 20 steps: a finite
       loss that falls, 0 rollout launches, samples/s an epoch; a ``wave``
       run stopped by SIGTERM after step 8 and resumed, bitwise equal to the
       uninterrupted run;
    e. ``cli.test_wave`` on both bf16 checkpoints over the whole test split
       (60 sequences x 106 windows, B 256): finite ``mse_t40``, the
       ``evals.json`` record, 0 launches;
    f. ``eval.wave.evaluate(model_bundle=...)`` on the f32 seed-0 WaveEq
       model: one streaming launch a batch and no cluster launch (no cluster
       holds 3 blocks at H 512); per-sequence MSE of the first 2 batches,
       card against CPU; the streaming kernel against plain at B 256 x 45
       steps x 3 blocks, timed in turns with the plain and ``addmm`` loops,
       beside the bound, with its plan (cluster, rows, ring stages, shared
       memory, waves) and its us a block-step.
11. 3D Chairs (the recipe of ``tests/test_recipes.py:18-19``, full width), in
    a temporary directory:
    a. the kernel at the chairs shapes, with phase 3's cases;
    b. the ResNet-18 encoder and DCGAN decoder of the seed-0 model, card
       against CPU, f32 (TF32 off) and bf16, eval and train mode; one f32 chairs train step at B 8,
       card against CPU, with phase 6's tolerances and 0 launches;
    c. ``cli.gen_synthetic chairs --n_objects 100`` (6,200 PNGs); the train
       split on the card (``DeviceChairs``, uint8) and a B 128 batch of the
       same draws against the host ``Chairs`` items, bitwise;
    d. the train CLI, bf16 B 128, 2 epochs x 20 steps: the loss falls, 0
       launches, samples/s; a run stopped by SIGTERM and resumed, bitwise
       under ``cudnn.deterministic``; the host data path;
    e. ``cli.test_chairs_disentanglement --nt_pred 10`` on the bf16
       checkpoint over the whole test split (930 sequences), 0 launches,
       and its resume, bitwise;
    f. ``eval.chairs_swap.evaluate(model_bundle=...)`` on the f32 seed-0
       model: one cluster launch a batch; the Evaluator card against CPU on
       2 batches; the kernel at B 16 x 15 steps timed in turns with the
       streaming kernel, the plain and ``addmm`` loops, beside the bound.
12. TaxiBJ (the recipe of ``tests/test_recipes.py:22-25``, full width: VGG
    at nf 64, S 128, T 20, a 1-block MLP-ResNet at H 512, 4 + 4 frames of
    32x32x2, offset 4, B 100), in a temporary directory.  The stand-in
    (``taxibj_years``, 4 years x 120 days) is made in memory and goes
    through ``TaxiBJ.from_arrays``, the pipeline the loader runs on the
    reference's files; phase 18 runs the file path (the port's own HDF5
    reader and writer, loader, cache, CLIs) on the same stand-in and this
    phase's experiment:
    a. the VGG encoder and decoder of the seed-0 model, card against CPU, f32
       (TF32 off) and bf16, eval and train mode; one f32 train step at B 8,
       card against CPU, with phase 6's tolerances and 0 launches;
    b. the stand-in's and the split's seconds; ``DeviceItems`` over the
       train split (1.42 GB) and a B 100 batch of the same draws against the
       host items, bitwise;
    c. ``run_training(device_gen=...)`` at the recipe, bf16, 2 epochs x 10
       steps: the loss falls, 0 launches, samples/s and a profiler trace of
       one fused step (busy ms, idle share); a run stopped by SIGTERM after
       step 8 and resumed, bitwise under ``cudnn.deterministic``;
    d. ``eval.taxibj.evaluate`` on the bf16 checkpoint over the whole test
       split (1,344 sequences, 11 batches of 128), the ``evals.json`` record
       the CLI writes, 0 launches;
    e. ``evaluate(model_bundle=...)`` on the f32 seed-0 model: one cluster
       launch a batch (C 8 x 16 clusters, one more than fit at once); frame
       MSEs card against CPU on 2 batches; the kernel at B 128 x 8 steps
       against plain, timed in turns with the streaming kernel, the plain
       and ``addmm`` loops, beside the bound.
13. SST (the recipe of ``tests/test_recipes.py:26-29``, full width:
    ``EncoderSST``, ``DecoderSSTSkip``, 16x16 S and T maps of 196 and 64
    channels, a 2-block ``ConvResnet`` at nf 512, 4 + 6 frames of 64x64,
    B 128), in the same way (``sst_zone_arrays``, 29 zones x 1,600 days,
    through ``SST(arrays=...)``):
    a. ``EncoderSST``, ``DecoderSSTSkip`` and ``ConvResnet`` of the seed-0
       model, card against CPU, as 12a; one f32 train step at B 8; one bf16
       forward at ``--zone_size 256``;
    b. as 12b with ``DeviceZoneWindows`` (0.76 GB) and a B 128 batch;
    c. as 12c, without the profiler trace;
    d. ``eval.sst.evaluate`` on the bf16 checkpoint over zones 17-20 (1,220
       sequences, B 64): finite MSEs, SSIM in (0, 1], the ``evals.json``
       record, 0 launches;
    e. ``evaluate(model_bundle=...)`` on the f32 seed-0 model: 0 launches of
       either kernel (``ConvResnet`` loops its module); per-sequence MSE and
       SSIM card against CPU on 2 batches of 16, and with
       ``reference_broadcast`` on 1.
14. ``--no_s``, the stability probe and the operations tooling, in a
    temporary directory beside phase 8's digits and checkpoint:
    a. the ``wave`` recipe with ``--no_s`` at full width (codes 32, MLP
       1200, 3 blocks at H 512, B 128), f32, 6 steps through the train CLI
       on a 10 x 90 ``gen_wave`` corpus made on the card: ``s_inv`` exactly 0
       at every step, 0 launches; its f32 eval forecast (B 128 x 45 frames)
       through the streaming kernel (1 launch), against the CPU within the
       rollout tolerance, its frames within the module tolerance over the
       steps with |T| <= 1e3 and within 1e-3 over all, S all ones;
    c. ``--monitor_stability`` on a short f32 flagship run (B 32, 2 epochs
       x 3 steps, a checkpoint an epoch) against the same run without it,
       under ``cudnn.deterministic``: params, BatchNorm statistics and Adam
       state bitwise equal, one ``stability.csv`` row and one cluster launch
       a checkpoint;
    b. the ``diagnose`` CLI (``--epoch all``, B 32 x 20 steps) on 14c's
       f32 flagship checkpoints (one cluster launch each) and on 14a's f32
       WaveEq checkpoints (one streaming launch each), every report held
       against the CPU probe of the same checkpoint within 1e-4 relative,
       with the same verdict; then on phase 8's bf16 flagship checkpoints
       (0 launches), whose verdicts it prints;
    d. ``supervise`` over the port's train CLI in child processes (the
       flagship, bf16 B 128, 2 epochs x 10 steps, ``cudnn.deterministic``
       in each child): an uninterrupted run; the same run stopped once by
       the supervisor's deadline, which its clock passes once the child
       prints step 5 (SIGTERM, the guarded final save), and finished by a
       ``--resume`` relaunch; the two final checkpoints bitwise equal; each
       child prints its rollout launches (0) for the kernels line;
    e. ``summarize`` over 14's experiments, ``visualize`` over phase 9's
       archive, ``gen_synthetic mnist`` against the pinned sha256 of its
       four idx files (no scikit-learn, no cv2), ``verify_corpus`` for
       mnist (on that stand-in and ``make_mnist_test``'s set), wave (14a's
       corpus) and chairs (a 5-object stand-in), each with exit 0 (phase
       18b verifies the TaxiBJ and SST files).
15. data and tensor parallelism (``parallel/``) on the one card, in a
    temporary directory beside phase 9's test set.  One card cannot show NCCL
    across ranks or hosts; it shows a world-1 NCCL group, two processes
    sharing the card over gloo, and a mesh that names the card twice:
    a. a world-1 NCCL group on the card: 3 bf16 flagship steps (B 128)
       through DDP and the global-batch BatchNorm, bitwise against the plain
       step under ``cudnn.deterministic`` (params, statistics, Adam state);
    b. two ranks sharing the card over gloo (``parallel.distributed.launch``),
       the global batch B 128 = 2 x 64 of uniform noise: one f64 and one f32
       (TF32 off) step against one process on the card: the loss and the
       BatchNorm statistics at the CPU test's tolerances in both, the
       rank-averaged gradients at its 1e-4 in f64 and, in f32, each side
       within phase 6's tolerance of the f64 step (see PAR_GRAD_TOL); the
       statistics, gradients and logged loss equal on both ranks; then
       ``PAR_BF16_STEPS`` bf16 flagship steps on each rank with a finite
       loss, and each rank's seconds from the spawn to the end of each
       stage.  15a-c launch
       the rollout kernel 0 times (counted over all of their steps);
    c. in the world-1 NCCL group, tensor parallel at (data 1, model 1): gloo
       cannot carry DTensor's collectives of CUDA tensors (see
       ``tensor_parallel_world_one``), so the flagship's kernels take the
       placements of the (1, 2) mesh on a model axis of one rank; one f32
       SGD step held to the JAX package's tolerances against one process;
    d. ``Evaluator`` over the mesh (cuda:0, cuda:0) on phase 3's f32 seed-0
       model and phase 9's test set, at B 16 and a ragged B 13: one cluster
       launch a shard a batch, the forecasts held against one device at the
       forecast tolerances;
    e. ``Forecaster`` over the same mesh at B 64 x 100: two launches a
       request (each shard's plan printed), the answers held against one
       device;
    f. ``cli.test_wave --devices 2`` on one card raises JAX's ``requested 2
       devices, have 1``; ``--devices 1`` runs (the wave recipe's f32 seed-0
       checkpoint on a small ``gen_wave`` corpus, through the streaming
       kernel).
16. the port's measurement programs, each through its ``main`` in this
    process at the least depth its flags take, its JSON line parsed:
    a. ``bench`` (1 + 5 steps, its five blocks): ``value``, ``mfu``,
       ``hbm_gb_per_step`` and the other figures finite and positive;
    b. ``tools.trace_flagship`` (1 + 1 steps, 3 traced): the traffic count,
       the utilization and the trace's busy ms positive, its trace written;
    c. ``tools.bench_horizon_remat``'s two t95 B 32 rows (1 + 1 steps) under
       ``cudnn.deterministic``: both measured, their losses equal (at
       phase 6's loss tolerance);
    d. ``tools.bench_serving_rollout`` (1 end-to-end call a precision):
       both kernels within the rollout tolerance of the plain rollout, no
       launch in bf16.
    The rollout kernel launches 0 times in a-c.
17. a migrated reference experiment, the flagship at full width in f32:
    a. a stand-in of the reference's experiment layout (its code is not on
       the card machine): four pickles of plain ``torch.nn`` layers in the
       reference's order holding the seed-0 weights, with random BatchNorm
       statistics, and a ``params.json`` without precision;
    b. ``cli.import_torch`` in this process: the imported weights bitwise
       the stand-in's, f32 pinned, no launch;
    c. ``load_for_eval`` on the card and ``Forecaster`` at B 64 x 100: one
       cluster-kernel launch a request, the forecast within phase 5's
       tolerances of the same experiment's CPU forecast (the plain rollout,
       the first windows) and its T codes within the rollout tolerance;
    d. ``cli.export_torch`` (the stand-in builder in place of the
       reference's factory) and the export imported again: both bitwise;
    e. ``enable_compilation_cache`` resolves the root phase 2 built into,
       and every loaded kernel came from there (no build in this phase).
18. TaxiBJ and SST from their HDF5 files, on phases 12-13's experiments
    and splits; the files are written and read by the port's own HDF5
    module (``data/hdf5.py``), never h5py:
    a. ``gen_synthetic taxibj`` (4 years x 120 days, 12's stand-in) and
       ``gen_synthetic sst`` (29 zones x 1,600 days at 64x64, 13's) through
       their CLI: MB and seconds; h5py not imported; one file of each read
       and written again alone (ms, MB/s, the rewrite byte-equal);
    b. ``verify_corpus taxibj`` and ``verify_corpus sst``, exit 0 (run
       after c-d, on the cache c built);
    c. ``TaxiBJ.make_datasets`` over the files, built and then read back
       from its cache: train and test windows and min/max bitwise phase
       12's ``from_arrays`` splits; seconds of each;
    d. ``SST`` over the files, the train split (29 zones) and the eval split
       (zones 17-20): bitwise phase 13's ``SST(arrays=...)`` splits;
    e. the TaxiBJ recipe through ``cli.main --data taxibj --data_dir`` the
       files, 1 epoch of 5 steps: finite losses, ms a step, 0 launches;
    f. under ``cudnn.deterministic``: ``cli.test_taxibj`` from the files on
       phase 12's experiment in f32 (its checkpoint with ``precision`` f32
       in a copy of its ``params.json``): one cluster launch a batch (C 8 x
       16 at B 128 x 8), ``mse_t4`` bitwise the same eval of the in-memory
       test split (12d's route) with the same launches; ``cli.test_sst``
       from the files on phase 13's experiment: the four means bitwise the
       in-memory eval's (13d's route), 0 launches.
19. the DCGAN decoder's transposed convs through ``ops/transposed_conv.py`` (f32,
    eval, no grad: the route ``DCGAN64Decoder`` takes on the card), on the seed-0
    flagship's own codes at the serving shape (B 64 x 100 = 6,400 frames) and an
    Evaluator's (B 16 x 10): each stage against the plain version in f64 on the CPU
    (the serving shape's first 64 frames) and against cuDNN's f32
    ``F.conv_transpose2d`` + BatchNorm + activation, TF32 off; its time beside its
    bound (3xTF32 at a third of the dense TF32 rate, the frame stage's f32 FMAs, or
    its bytes), the plain version's time and that library path's (``library_ms``,
    which the port never calls on this path); 5 launches a B 64 x 100 request (one
    decode fold) and 0 in an f32 train step; requests of 1, 8, 17, 33 and 63
    windows (the encoders padded to B 64, the rollout and the decoder on the rows
    asked for): their frames bitwise the 64-window request's first rows, their
    ``rows_computed`` the rows asked for, 5 launches and 1 rollout launch each, each
    answer in page-locked host memory (its ``copy_back`` record counts ``pinned``
    1), and the seconds they take; three 64-window answers held across ten later
    64-window requests on other windows, bitwise as they were (the caching host
    allocator hands no block a caller holds to a later request); and the serving
    cell's ``frame_gap`` on 12 seeds through ``benchmark/calibrate.py``, at most a
    fifth of its limit.
Each phase, and each part of phases 12-13, 14, 15 and 16, prints its seconds on
a line of its own; a line before the JSON lines lists every phase's seconds.

The line before the last is a JSON object with one entry per kernel (its
serving-path launches, its launches on each eval path in ``launches_eval``,
on the WaveEq paths in ``launches_wave``, on the chairs paths in
``launches_chairs``, on the TaxiBJ paths in ``launches_taxibj`` and on the
SST paths in ``launches_sst``, with its B 16 plan and times, the streaming
kernel's ``wave_*`` times at the WaveEq shape, both kernels' ``chairs_*``
times at the chairs shape, and the cluster kernel's ``taxibj_*`` times at
B 128 x 8, its launches on phase 14's paths in ``launches_ops``, on
phase 15's paths in ``launches_parallel``, in phase 16's programs in
``launches_bench``, on phase 17's in ``launches_import`` and on phase 18's
in ``launches_hdf5``), and one for the decoder kernel (phase 19's launches, gaps and
times at both shapes); it is printed when every phase ran.  The last line is
``{"ok": true, "device": {...}, "checks": N}``, N the checks that ran and passed.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import csv
import dataclasses
import hashlib
import importlib.util
import io
import itertools
import json
import os
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch import bench as port_bench
from spatiotemporal_variable_separation_tpu_torch import checkpoint
from spatiotemporal_variable_separation_tpu_torch.bench import (
    card_peaks,
    cuda_ms,
    device_profile,
    nvidia_smi,
)
from spatiotemporal_variable_separation_tpu_torch.checkpoint import load_for_eval
from spatiotemporal_variable_separation_tpu_torch.core.activations import activation
from spatiotemporal_variable_separation_tpu_torch.cli import diagnose as cli_diagnose
from spatiotemporal_variable_separation_tpu_torch.cli import export_torch as cli_export_torch
from spatiotemporal_variable_separation_tpu_torch.cli import gen_synthetic as cli_gen_synthetic
from spatiotemporal_variable_separation_tpu_torch.cli import import_torch as cli_import_torch
from spatiotemporal_variable_separation_tpu_torch.cli import main as cli_main
from spatiotemporal_variable_separation_tpu_torch.cli import make_mnist_test as cli_make_mnist_test
from spatiotemporal_variable_separation_tpu_torch.cli import summarize as cli_summarize
from spatiotemporal_variable_separation_tpu_torch.cli import supervise as cli_supervise
from spatiotemporal_variable_separation_tpu_torch.cli import (
    test_chairs_disentanglement as cli_test_chairs,
)
from spatiotemporal_variable_separation_tpu_torch.cli import test_mnist as cli_test_mnist
from spatiotemporal_variable_separation_tpu_torch.cli import (
    test_mnist_disentanglement as cli_test_swap,
)
from spatiotemporal_variable_separation_tpu_torch.cli import test_sst as cli_test_sst
from spatiotemporal_variable_separation_tpu_torch.cli import test_taxibj as cli_test_taxibj
from spatiotemporal_variable_separation_tpu_torch.cli import test_wave as cli_test_wave
from spatiotemporal_variable_separation_tpu_torch.cli import verify_corpus as cli_verify_corpus
from spatiotemporal_variable_separation_tpu_torch.cli import visualize as cli_visualize
from spatiotemporal_variable_separation_tpu_torch.cli.options import build_parser, config_from_args
from spatiotemporal_variable_separation_tpu_torch.data import (
    hdf5,
    registry,
    synthetic_corpora,
    wave_eq,
)
from spatiotemporal_variable_separation_tpu_torch.data.chairs import Chairs
from spatiotemporal_variable_separation_tpu_torch.data.chairs_device import DeviceChairs
from spatiotemporal_variable_separation_tpu_torch.data.mnist_device import (
    DeviceMovingMNIST,
    stochastic_positions,
)
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import (
    MovingMNIST,
    composite,
    load_mnist,
    make_test_set,
    synthetic_digits,
)
from spatiotemporal_variable_separation_tpu_torch.data.sst import SST
from spatiotemporal_variable_separation_tpu_torch.data.sst_device import DeviceZoneWindows
from spatiotemporal_variable_separation_tpu_torch.data.taxibj import TaxiBJ
from spatiotemporal_variable_separation_tpu_torch.data.taxibj_device import DeviceItems
from spatiotemporal_variable_separation_tpu_torch.data.wave_device import DeviceWaveEq
from spatiotemporal_variable_separation_tpu_torch.eval import chairs_swap as eval_chairs
from spatiotemporal_variable_separation_tpu_torch.eval import common as eval_common
from spatiotemporal_variable_separation_tpu_torch.eval import mnist as eval_mnist
from spatiotemporal_variable_separation_tpu_torch.eval import mnist_swap as eval_swap
from spatiotemporal_variable_separation_tpu_torch.eval import sst as eval_sst
from spatiotemporal_variable_separation_tpu_torch.eval import taxibj as eval_taxibj
from spatiotemporal_variable_separation_tpu_torch.eval import wave as eval_wave
from spatiotemporal_variable_separation_tpu_torch.eval.common import Evaluator
from spatiotemporal_variable_separation_tpu_torch.eval.diagnostics import diagnose
from spatiotemporal_variable_separation_tpu_torch.eval.mnist_swap import SwapDataset
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.models.integrator import MLPResnet
from spatiotemporal_variable_separation_tpu_torch.ops import _build
from spatiotemporal_variable_separation_tpu_torch.ops.rollout import (
    SMEM_LIMIT,
    STREAM_STAGES,
    cluster_library,
    cluster_smem_bytes,
    mlp_resnet_rollout,
    mlp_resnet_rollout_reference,
    rollout_plan,
    stream_active_clusters,
    stream_library,
)
from spatiotemporal_variable_separation_tpu_torch.ops.ssim import ssim_map, ssim_per_frame
from spatiotemporal_variable_separation_tpu_torch.ops.transposed_conv import (
    BatchNormStats,
    transposed_conv,
    transposed_conv_reference,
)
from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster
from spatiotemporal_variable_separation_tpu_torch.tools import (
    bench_horizon_remat,
    bench_serving_rollout,
    trace_flagship,
)
from spatiotemporal_variable_separation_tpu_torch.tools.bench_serving_rollout import step_rel_err
from spatiotemporal_variable_separation_tpu_torch.train import (
    TrainState,
    create_train_state,
    make_fused_datagen_step,
    make_optimizer,
    make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.train.loop import run_training
from spatiotemporal_variable_separation_tpu_torch.train.step import DATA_SALT, step_seed
from spatiotemporal_variable_separation_tpu_torch.utils import compile_cache
from spatiotemporal_variable_separation_tpu_torch.utils import export as export_mod
from spatiotemporal_variable_separation_tpu_torch.utils.compile_cache import (
    enable_compilation_cache,
)
from spatiotemporal_variable_separation_tpu_torch.utils.profiling import span_log
from spatiotemporal_variable_separation_tpu_torch.utils.transplant import (
    REFERENCE_FILES,
    reference_units,
    unit_tensors,
)

B, N_FORECAST = 64, 100
REQUESTS = (64, 17, 1)  # windows per request: full, padded, single
ROW_REQUESTS = (1, 8, 17, 33, 63)  # phase 19: smaller requests against the full one
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
# The published peaks of the H100 parts live in the port's bench module
# (``card_peaks``).

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
FLAGSHIP = dict(port_bench.FLAGSHIP)  # bench.py:72-80
TRAIN_STEPS, WARMUP_STEPS, TIMED_STEPS = 40, 3, 20
# The loss after TRAIN_STEPS steps on one fixed batch, against the first
# step's: 0.0306 measured on an H100 (129.7 -> 3.97); 0.1 leaves 3x room
# for cuDNN's run-to-run atomics and the bf16 roundings.
LOSS_FALL = 0.1

# -- phase 8: the train entry point ---------------------------------------
N_DIGITS = 60_000  # synthetic stand-ins for MNIST's 60,000 training digits
CLI_EPOCHS, CLI_STEPS = 2, 20
RESUME_EPOCHS, RESUME_STEPS, RESUME_STOP_AFTER = 2, 6, 8
HOST_STEPS = 4
# The CLI's loss at its last logged step (40) against its first (step 5),
# a fresh batch every step: 0.112 measured on an H100 (40.49 -> 4.55); 0.3
# leaves ~2.7x room for cuDNN's run-to-run atomics and the bf16 roundings.
CLI_LOSS_FALL = 0.3

# -- phase 9: evaluation ---------------------------------------------------
N_TEST_DIGITS = 1_000   # synthetic test digits: 500 sequences (the reference has 5,000)
TEST_SEQ_LEN = 100      # make_test_set's default, the reference's
EVAL_B = 16             # the eval CLIs' default batch
ARCHIVE_CAP = 256       # the CLIs' archives: the first 16 batches
# The 95-frame protocol on the checkpoint: 128 of 500 sequences (cut from 16
# batches for phase 16's time, see PERF.md section 4).
T95_MAX_BATCHES = 8
# The f32 bundle's runs, cut to these batches; the first 4 batches archived.
BUNDLE_MAX_BATCHES = {"mnist_t10": 20, "mnist_swap_t10": 10, "mnist_t95": 8}
BUNDLE_ARCHIVE_CAP = 64
RESUME_BATCHES, RESUME_KILL_AFTER = 6, 2
EVAL_TIMING_BATCHES = 8
EVAL_ROLLOUT_STEPS = 15  # nt_cond 5 + nt_pred 10: the t10 protocols' rollout
SSIM_FRAMES = 240
# SSIM on the card against the CPU (f32 and f64).  f32 moments of values up
# to 1, 121 products each, carry a few 1e-7 of error, and on a flat stroke
# the quotient divides it by c2 = 9e-4 (the variances vanish): a few 1e-4 on
# such pixels of the maps (phase 9a prints the CPU's own f32 against f64 at
# these frames).  Per-frame means average it to ~1e-6.  TF32 moments carry
# ~5e-4 relative error, two orders more, and break both bounds.
SSIM_MAP_TOL, SSIM_FRAME_TOL = 5e-3, 5e-5
# Per-sequence metrics of the seed-0 model, card against CPU, f32 with TF32
# off, 15 frames: the frames agree to ~1e-6 (cuDNN against oneDNN sums); an
# MSE of ~0.1 moves by ~1e-6 relative, PSNR by 4.34x that in dB.
EVAL_MSE_RTOL, EVAL_PSNR_ATOL, EVAL_SSIM_ATOL = 1e-4, 1e-3, 1e-4


#: The checks that ran and passed in this process (the last line's ``checks``).
checks_passed = 0


def check(ok: bool, what: str) -> None:
    global checks_passed
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")
    checks_passed += 1


def check_frames(out: np.ndarray, ref: np.ndarray, what: str) -> None:
    diff = np.abs(out - ref)
    off = float((diff > 1e-3).mean())
    print(f"{what}: mean abs {diff.mean():.3e} (tolerance {FRAME_MEAN_TOL:g}), max abs "
          f"{diff.max():.3e}, share off by >1e-3 {off:.3e} (tolerance {FRAME_OFF_FRAC_TOL:g})")
    check(diff.mean() <= FRAME_MEAN_TOL and off <= FRAME_OFF_FRAC_TOL, what)


def reset_launch_counts() -> None:
    mlp_resnet_rollout.launches = 0
    mlp_resnet_rollout.variant_launches = dict.fromkeys(mlp_resnet_rollout.variant_launches, 0)


def card_plan(batch: int, code: int, hidden: int, n_blocks: int, **kw):
    """``rollout_plan`` with the card's own count of streaming clusters that
    fit at once, as ``mlp_resnet_rollout`` plans a call itself."""
    return rollout_plan(batch, code, hidden, n_blocks,
                        active_clusters=stream_active_clusters(batch, code, hidden, n_blocks),
                        **kw)


def plan_text(plan) -> str:
    """C, R, the ring's stages, shared memory and waves of a plan."""
    text = f"{plan.variant} C {plan.cluster} x R {plan.rows}, {plan.smem_bytes} B a CTA"
    if plan.variant == "stream":
        text += (f", {STREAM_STAGES} ring stages, {plan.waves} wave(s), W1/biases/W3 "
                 f"{'resident' if plan.resident else 'from L2'}")
    return text


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


def rollout_cost(batch, code, hidden, n_blocks, n_steps):
    """(operations, bytes) of one rollout: matmul multiply-adds, bias adds,
    relus and residual adds; each input read once, the output written once."""
    per_row = 2 * (code * hidden + hidden * hidden + hidden * code) + 4 * hidden + 2 * code
    ops = batch * per_row * n_blocks * (n_steps - 1)
    weights = n_blocks * (2 * code * hidden + hidden * hidden + 2 * hidden + code)
    nbytes = 4 * (batch * code + weights + n_steps * batch * code)
    return ops, nbytes


def in_turns(fns: dict, reps: int, inner: int) -> tuple:
    """Each of ``fns`` ({name: call}) timed by ``cuda_ms`` in turns, in their
    order and then in reverse.  Returns ({name: mean ms}, {name: [ms, ms]})."""
    runs = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        runs[k].append(cuda_ms(fns[k], reps=reps, inner=inner))
    return {k: float(np.mean(v)) for k, v in runs.items()}, runs


def rollout_turns(ctx, t0, params, n: int, plans: dict, reps: int = 10, inner: int = 5) -> dict:
    """The one procedure that times the rollout kernels.  The rollout at (t0,
    n) through each of ``plans`` ({label: plan}), one launch each, held
    against the plain version; then timed by CUDA events in turns with the
    plain loop and the eager ``addmm`` loop (the plans, plain, addmm, then
    the same in reverse), beside its bound.  Returns the shapes, each plan's
    errors, the mean ms of each and its us a block-step, and the bound."""
    batch, code = t0.shape
    hidden, n_blocks = params[0].shape[1], len(params) // 6
    blocks = "1 block" if n_blocks == 1 else f"{n_blocks} blocks"
    shapes = f"B {batch}, code {code}, H {hidden}, {blocks}, {n} steps"
    ref = mlp_resnet_rollout_reference(t0, params, n)
    bufs = (torch.empty(n, batch, code, device=t0.device),
            torch.empty(batch, hidden, device=t0.device),
            torch.empty(batch, hidden, device=t0.device),
            torch.empty(batch, code, device=t0.device))
    check(step_rel_err(addmm_loop(t0, params, n, *bufs), ref) <= ROLLOUT_REL_TOL,
          f"addmm loop disagrees [{shapes}]")
    fns, rel, abs_err = {}, {}, {}
    for label, plan in plans.items():
        reset_launch_counts()
        out = mlp_resnet_rollout(t0, params, n, plan=plan)
        torch.cuda.synchronize()
        check(mlp_resnet_rollout.variant_launches[plan.variant] == 1, f"one {label} launch")
        rel[label], abs_err[label] = step_rel_err(out, ref), float((out - ref).abs().max())
        check(rel[label] <= ROLLOUT_REL_TOL, f"the {label} kernel disagrees with plain [{shapes}]")
        fns[label] = lambda plan=plan: mlp_resnet_rollout(t0, params, n, plan=plan)
    fns["plain"] = lambda: mlp_resnet_rollout_reference(t0, params, n)
    fns["addmm"] = lambda: addmm_loop(t0, params, n, *bufs)
    ms, runs = in_turns(fns, reps, inner)
    ops, nbytes = rollout_cost(batch, code, hidden, n_blocks, n)
    t_ops, t_bytes = ops / ctx.flops_peak * 1e3, nbytes / ctx.bw_peak * 1e3
    bound = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    block_step_us = {label: ms[label] / ((n - 1) * n_blocks) * 1e3 for label in plans}
    print(f"  rollout at {shapes}, in turns (mean of two medians of CUDA-event timings): "
          f"plain loop {ms['plain']:.4f} ms, eager addmm loop {ms['addmm']:.4f} ms; bound "
          f"{ops / 1e9:.4f} GFLOP at {ctx.flops_peak / 1e12:.1f} TFLOP/s f32 = {t_ops:.5f} ms, "
          f"{nbytes / 1e6:.4f} MB at {ctx.bw_peak / 1e12:.2f} TB/s = {t_bytes:.5f} ms: "
          f"{bound:.5f} ms by {bound_by}")
    for label, plan in plans.items():
        print(f"    {label}: {plan_text(plan)}: {ms[label]:.4f} ms ({runs[label][0]:.4f}, "
              f"{runs[label][1]:.4f}), {block_step_us[label]:.2f} us a block-step, "
              f"{bound / ms[label]:.1%} of the bound; against plain: worst step-relative "
              f"error {rel[label]:.3e} (tolerance {ROLLOUT_REL_TOL:g}), max abs "
              f"{abs_err[label]:.3e}")
    return {"shapes": shapes, "plans": plans, "ms": ms, "rel": rel, "abs": abs_err,
            "block_step_us": block_step_us, "bound_ms": bound, "bound_by": bound_by}


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


def train_step_card_vs_cpu(dev, cfg=None, seq=None, what: str = "Moving MNIST DCGAN") -> None:
    """Phase 6 (and 11b): one f32 train step on the card and on the CPU from
    the same weights, batch and t_random; by default phase 6's full-width
    DCGAN on moving squares."""
    if cfg is None:
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
    print(f"train step, card against CPU ({what}, f32, TF32 off, B {cfg.batch_size}, full "
          f"width, t_random {TRAIN_CHECK_T_RANDOM}): rollout kernel launches in the step "
          f"{launches}")
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


def flagship_train(ctx) -> None:
    """Phase 7: the flagship config trains on a fixed batch, its weights
    serve one request through the cluster kernel, and its bf16 step is
    timed."""
    dev = ctx.dev
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
    # The trained weights serve under ``mixed``: bf16 convs, the f32 rollout
    # kernel (``bf16`` serving loops its bf16 integrator and launches none).
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

    ms = port_bench.time_steps(lambda i: step(state, cond, target), WARMUP_STEPS, TIMED_STEPS,
                               dev)[0]
    print(f"  the bf16 step on {ctx.smi}: {ms:.3f} ms/step, {cfg.batch_size / ms * 1e3:.1f} "
          f"samples/s ({WARMUP_STEPS} warm-up, mean of {TIMED_STEPS} steps, host clock, fenced)")


def write_idx_images(path: str, images: np.ndarray) -> None:
    """A MNIST images idx3 file (the tests' writer, ``tests/conftest.py``)."""
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 2051))
        f.write(struct.pack(">III", *images.shape))
        f.write(images.tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    """A MNIST labels idx1 file (the tests' writer, ``tests/conftest.py``)."""
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 2049))
        f.write(struct.pack(">I", labels.shape[0]))
        f.write(labels.tobytes())


def flagship_argv(xp_dir: str, data_dir: str, epochs: int, steps: int, *extra) -> list:
    """``bench.py``'s flagship as train-CLI flags (``FLAGSHIP``)."""
    f = FLAGSHIP
    return ["--xp_dir", xp_dir, "--data_dir", data_dir, "--data", f["data"],
            "--batch_size", str(f["batch_size"]), "--precision", f["precision"], "--fused_loss",
            "--code_size_s", str(f["code_size_s"]), "--code_size_t", str(f["code_size_t"]),
            "--enc_hidden_size", str(f["enc_hidden_size"]),
            "--dec_hidden_size", str(f["dec_hidden_size"]),
            "--res_hidden_size", str(f["res_hidden_size"]), "--nt_cond", str(f["nt_cond"]),
            "--nt_pred", str(f["nt_pred"]), "--offset", str(f["offset"]),
            "--seed", str(f["seed"]), "--epochs", str(epochs), "--steps_per_epoch", str(steps),
            *extra]


def metrics_rows(xp_dir: str) -> list:
    with open(os.path.join(xp_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def train_state_tensors(state) -> dict:
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return out


def data_on_card(dev, digits: np.ndarray) -> DeviceMovingMNIST:
    """Phase 8a: a flagship batch drawn on the card, rendered on the card and
    on the CPU from the same draws; the stochastic solver likewise."""
    cfg = ExperimentConfig(**FLAGSHIP)
    seq_len, batch = cfg.nt_cond + cfg.nt_pred, cfg.batch_size
    gen = DeviceMovingMNIST(digits, cfg.nt_cond, seq_len, cfg.n_object, device=dev)
    cpu_gen = DeviceMovingMNIST(digits, cfg.nt_cond, seq_len, cfg.n_object, device="cpu")
    draws = gen.draw(torch.Generator(device=dev).manual_seed(8), batch)
    card = gen.render(gen.data, draws).cpu().numpy()
    cpu = cpu_gen.render(cpu_gen.data, draws.to("cpu")).numpy()
    limit = gen.frame_size - gen.digit_size
    from spatiotemporal_variable_separation_tpu_torch.data.mnist_device import fold_positions

    pos = fold_positions(draws.s0, draws.vel, seq_len, limit).cpu().numpy()
    host = composite(np.concatenate([pos, np.zeros_like(pos)], axis=-1),
                     digits[draws.idx.cpu().numpy()], gen.frame_size)
    print(f"data on the card, B {batch} x {seq_len} frames, {cfg.n_object} digits of "
          f"{len(digits)}: frames in [{card.min():.3f}, {card.max():.3f}], mean {card.mean():.4f}; "
          f"card == CPU bitwise: {card.tobytes() == cpu.tobytes()}; == host composite bitwise: "
          f"{card.tobytes() == host.tobytes()}")
    check(card.shape == (batch, seq_len) + cfg.frame_shape, "device batch shape")
    check(card.tobytes() == cpu.tobytes(), "device frames differ between the card and the CPU")
    check(card.tobytes() == host.tobytes(), "device frames differ from the host composite")

    sgen = DeviceMovingMNIST(digits, cfg.nt_cond, seq_len, cfg.n_object, deterministic=False,
                             device=dev)
    sdraws = sgen.draw(torch.Generator(device=dev).manual_seed(9), batch)
    s_card = stochastic_positions(sdraws.s0, sdraws.vel, sdraws.bounce, limit, return_counts=True)
    c = sdraws.to("cpu")
    s_cpu = stochastic_positions(c.s0, c.vel, c.bounce, limit, return_counts=True)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(s_card, s_cpu))
    frames_same = torch.equal(sgen.render(sgen.data, sdraws).cpu(),
                              cpu_gen.render(cpu_gen.data, c))
    print(f"  stochastic bounce solver: {int(s_card[1].sum())} bounces, at most "
          f"{int(s_card[1].max())} in a step; positions and counts card == CPU bitwise: {same}; "
          f"frames: {frames_same}")
    check(same and frames_same, "stochastic positions differ between the card and the CPU")
    return gen


def train_cli(ctx) -> types.SimpleNamespace:
    """Phase 8b, the product ``ctx.checkpoint``: the train CLI at the
    flagship config on phase 8's digits, its checkpoint saved and restored
    bitwise.  Returns its ``xp`` and trained ``state``."""
    data_dir = ctx.digits.data_dir
    xp = os.path.join(ctx.work, "cli")
    argv = flagship_argv(xp, data_dir, CLI_EPOCHS, CLI_STEPS, "--chkpt_interval", "1",
                         "--log_every", "5")
    print("train CLI: python -m spatiotemporal_variable_separation_tpu_torch.cli.main "
          + " ".join(argv))
    reset_launch_counts()
    state = cli_main.main(argv)
    launches = dict(mlp_resnet_rollout.variant_launches)
    rows = metrics_rows(xp)
    names = checkpoint.list_checkpoints(xp)
    losses = [(int(r["step"]), float(r["loss"])) for r in rows if not r["samples_per_sec"]]
    epochs = [float(r["samples_per_sec"]) for r in rows if r["samples_per_sec"]]
    print(f"  steps {state.step}, checkpoints {names}, {len(rows)} metrics.csv rows, rollout "
          f"kernel launches while training {launches}")
    print("  loss by step: " + ", ".join(f"{s}: {v:.4f}" for s, v in losses))
    check(state.step == CLI_EPOCHS * CLI_STEPS, "CLI step count")
    check(names == sorted(["final"] + [str(e + 1) for e in range(CLI_EPOCHS)]),
          "CLI checkpoints")
    check(launches == {"cluster": 0, "stream": 0}, "training launched the rollout kernel")
    check(len(losses) >= 2 and all(np.isfinite(v) for _, v in losses), "CLI loss rows")
    print(f"  last/first logged loss {losses[-1][1] / losses[0][1]:.4f} (must be below "
          f"{CLI_LOSS_FALL:g})")
    check(losses[-1][1] < CLI_LOSS_FALL * losses[0][1], "the CLI's loss did not fall")
    batch = FLAGSHIP["batch_size"]
    for e, sps in enumerate(epochs):
        print(f"  epoch {e}: {sps:.1f} samples/s = {batch / sps * 1e3:.3f} ms/step"
              + (" (includes the first step's warm-up)" if e == 0 else ""))
    check(len(epochs) == CLI_EPOCHS, "one samples/s row an epoch")

    checkpoint.save_checkpoint(xp, state, name="round_trip")
    cfg = ExperimentConfig.from_json_file(os.path.join(xp, "params.json"))
    fresh = create_train_state(cfg, CLI_STEPS, device=ctx.dev)
    checkpoint.restore_checkpoint(xp, fresh, name="round_trip")
    same = all(torch.equal(a, b) for a, b in zip(train_state_tensors(state).values(),
                                                 train_state_tensors(fresh).values()))
    print(f"  checkpoint saved and restored: state bitwise equal: {same}")
    check(same, "checkpoint round trip on the card")
    return types.SimpleNamespace(xp=xp, state=state)


def resume_on_card(dev, data_dir: str, work: str) -> None:
    """Phase 8c: an uninterrupted run against one stopped by SIGTERM and
    resumed, under cudnn.deterministic."""
    torch.backends.cudnn.deterministic = True
    argv = flagship_argv("", data_dir, RESUME_EPOCHS, RESUME_STEPS)
    states, losses = {}, {}
    for run in ("a", "b"):
        cfg = config_from_args(build_parser().parse_args(argv)).validate()
        cfg = dataclasses.replace(cfg, xp_dir=os.path.join(work, f"resume_{run}"))
        os.makedirs(cfg.xp_dir)
        cfg.save(os.path.join(cfg.xp_dir, "params.json"))
        if run == "b":
            def stop(msg):  # loss lines lag one boundary: after step 8 is logged
                if f"step {RESUME_STOP_AFTER}:" in msg:
                    os.kill(os.getpid(), signal.SIGTERM)
            stopped = run_training(cfg, device=dev, log_every=1, log_fn=stop)
            print(f"  run B stopped by SIGTERM at step {stopped.step}; checkpoints "
                  f"{checkpoint.list_checkpoints(cfg.xp_dir)}")
            check(stopped.step == RESUME_STOP_AFTER + 1, "run B did not stop after the SIGTERM")
        states[run] = run_training(cfg, device=dev, log_every=1, log_fn=lambda s: None,
                                   resume=run == "b")
        losses[run] = {int(r["step"]): r["loss"] for r in metrics_rows(cfg.xp_dir)}
    torch.backends.cudnn.deterministic = False
    ta, tb = train_state_tensors(states["a"]), train_state_tensors(states["b"])
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    shared = sorted(set(losses["a"]) & set(losses["b"]))
    loss_differ = [s for s in shared if losses["a"][s] != losses["b"][s]]
    print(f"resume on the card (cudnn.deterministic, {RESUME_EPOCHS} epochs x {RESUME_STEPS} "
          f"steps, stop after step {RESUME_STOP_AFTER}): steps {states['a'].step} and "
          f"{states['b'].step}; {len(differ)} of {len(ta)} tensors (params, BatchNorm "
          f"statistics, Adam state) differ; {len(loss_differ)} of {len(shared)} shared loss "
          f"strings differ")
    check(states["a"].step == states["b"].step == RESUME_EPOCHS * RESUME_STEPS,
          "resumed step count")
    if differ or loss_differ:
        # an op stayed nondeterministic: hold the run to phase 6's tolerances
        print(f"  NOT bitwise: first differing tensors {differ[:5]}, steps {loss_differ[:5]}; "
              "held to phase 6's tolerances instead")
        for s in shared:
            a, b = float(losses["a"][s]), float(losses["b"][s])
            check(abs(a - b) <= TRAIN_LOSS_RTOL * abs(a), f"resumed loss at step {s}")
        worst, err = layer_rel_err({k: v.double().cpu() for k, v in tb.items() if "running" in k},
                                   {k: v.double().cpu() for k, v in ta.items() if "running" in k})
        check(err <= TRAIN_STATS_TOL, f"resumed BatchNorm statistics at {worst}")


def host_path(dev, data_dir: str, work: str, device_sps: float) -> None:
    """Phase 8d: the train CLI on the host data path."""
    xp = os.path.join(work, "host")
    cli_main.main(flagship_argv(xp, data_dir, 1, HOST_STEPS, "--no-device_datagen",
                                "--num_workers", "4", "--log_every", "5"))
    sps = [float(r["samples_per_sec"]) for r in metrics_rows(xp) if r["samples_per_sec"]]
    cfg = ExperimentConfig(**FLAGSHIP)
    ds = MovingMNIST.make_dataset(data_dir, 64, cfg.nt_cond, cfg.nt_cond + cfg.nt_pred, 4, True,
                                  cfg.n_object, train=True)
    t = time.perf_counter()
    for _ in range(3):
        ds.generate_batch(cfg.batch_size)
    gen_ms = (time.perf_counter() - t) / 3 * 1e3
    print(f"host data path (--no-device_datagen --num_workers 4), 1 epoch x {HOST_STEPS} steps: "
          f"{sps[0]:.1f} samples/s (device datagen, epoch 2: {device_sps:.1f}); "
          f"MovingMNIST.generate_batch({cfg.batch_size}) alone on this machine's CPU: "
          f"{gen_ms:.1f} ms a batch")
    check(len(sps) == 1 and sps[0] > 0, "host-path samples/s")


def serve_checkpoint(dev, xp: str, trained_model, gen: DeviceMovingMNIST) -> dict:
    """Phase 8e: Forecaster.from_xp_dir on the CLI's checkpoint, against a
    Forecaster over the CLI's model in memory."""
    mixed = ExperimentConfig(**{**FLAGSHIP, "precision": "mixed"})
    cond = gen.generate_device_batch(torch.Generator(device=dev).manual_seed(5), B)[0]
    cond = cond.cpu().numpy()
    fc = Forecaster.from_xp_dir(xp, B, N_FORECAST, precision="mixed", device=dev)
    reset_launch_counts()
    frames = fc.predict(cond)
    launches = dict(mlp_resnet_rollout.variant_launches)
    print(f"from_xp_dir request (mixed, B{B} x {N_FORECAST}, the CLI's final checkpoint): "
          f"rollout kernel launches {launches}, frames in [{frames.min():.3f}, {frames.max():.3f}]")
    check(launches == {"cluster": 1, "stream": 0}, "one cluster-kernel launch for from_xp_dir")
    check(frames.shape == (B, N_FORECAST) + mixed.frame_shape and bool(np.isfinite(frames).all())
          and bool(((frames >= 0) & (frames <= 1)).all()), "from_xp_dir forecast")
    in_memory = build_separable_network(mixed, dev, torch.Generator().manual_seed(0))
    in_memory.load_state_dict(trained_model.state_dict())
    ref_fc = Forecaster(in_memory, mixed, B, N_FORECAST, device=dev)
    # Held with cuDNN's deterministic algorithms: the trained model's T grows
    # over the 100 steps until the bf16 decoder saturates, and there the
    # default algorithms' atomics flip whole pixels between two calls (the
    # same request twice, printed below).
    torch.backends.cudnn.deterministic = True
    exact, ref = fc.predict(cond), ref_fc.predict(cond)
    torch.backends.cudnn.deterministic = False
    print(f"  with cudnn.deterministic, from_xp_dir == the in-memory model bitwise: "
          f"{exact.tobytes() == ref.tobytes()}")
    check_frames(exact, ref, "from_xp_dir forecast vs a Forecaster over the CLI's model")
    again = fc.predict(cond)
    diff = np.abs(again - frames)
    with torch.inference_mode():
        t_codes = fc.model.get_forecast(torch.from_numpy(cond).to(dev), N_FORECAST)[1]
    t_max = t_codes.abs().amax(dim=(0, 2)).float().cpu().numpy()
    print(f"  the same request twice with cuDNN's default algorithms: mean abs {diff.mean():.3e}, "
          f"max abs {diff.max():.3e}, share off by >1e-3 {float((diff > 1e-3).mean()):.3e}; "
          f"max |T| at steps " + ", ".join(f"{k}: {t_max[k]:.3g}" for k in
                                           (0, N_FORECAST // 10, N_FORECAST // 2, N_FORECAST - 1)))
    return launches


def write_digits(ctx) -> types.SimpleNamespace:
    """Phase 8's product ``ctx.digits``: synthetic stand-ins for MNIST's
    training digits, in memory (``images``) and written as its idx file to
    a data directory (``data_dir``)."""
    data_dir = os.path.join(ctx.work, "mnist_data")
    os.makedirs(data_dir)
    t = time.perf_counter()
    images = synthetic_digits(N_DIGITS)
    write_idx_images(os.path.join(data_dir, "train-images-idx3-ubyte"), images)
    print(f"phase 8: {N_DIGITS} synthetic digits written as idx in "
          f"{time.perf_counter() - t:.1f} s")
    return types.SimpleNamespace(data_dir=data_dir, images=images)


def train_entry_point(ctx) -> None:
    """Phase 8: the train entry point at full width, on the card, on the
    digits of ``ctx.digits``; 8b is ``ctx.checkpoint``."""
    dev, data_dir = ctx.dev, ctx.digits.data_dir
    gen = data_on_card(dev, ctx.digits.images)
    ckpt = ctx.checkpoint
    resume_on_card(dev, data_dir, ctx.work)
    host_path(dev, data_dir, ctx.work, float(metrics_rows(ckpt.xp)[-1]["samples_per_sec"]))
    served = serve_checkpoint(dev, ckpt.xp, ckpt.state.model, gen)
    print(f"rollout kernel launches on the from_xp_dir request: {served}")


# -- phase 9: evaluation -----------------------------------------------------

def ssim_window_f64() -> np.ndarray:
    """The reference's 11x11 window (sigma 1.5), a softmax over the grid, in f64."""
    g = -(np.arange(11) - 5.0) ** 2 / (2.0 * 1.5 ** 2)
    e = np.exp(g[None, :] + g[:, None])
    return e / e.sum()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with its mantissa rounded (to nearest) to TF32's 10 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def one_channel_blur(z: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, H - 10, W - 10): every channel filtered by the
    11x11 ``win`` in one convolution of one channel (not depthwise)."""
    n, c, h, w = z.shape
    out = torch.nn.functional.conv2d(z.reshape(n * c, 1, h, w), win[None, None])
    return out.reshape(n, c, h - 10, w - 10)


def ssim_from_moments(x: torch.Tensor, y: torch.Tensor, blur) -> torch.Tensor:
    """The SSIM map of NCHW batches with ``blur`` as the moment filter."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = blur(x), blur(y)
    s11 = blur(x * x) - mu1 ** 2
    s22 = blur(y * y) - mu2 ** 2
    s12 = blur(x * y) - mu1 * mu2
    return ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 ** 2 + mu2 ** 2 + c1) * (s11 + s22 + c2))


def ssim_map_f64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The plain SSIM map of two (N, H, W, C) batches with every product and
    sum in f64: the reference's formulas (softmax window, depthwise VALID
    moments), written out apart from ``ops/ssim.py``."""
    x = torch.from_numpy(np.asarray(a, np.float64)).permute(0, 3, 1, 2)
    y = torch.from_numpy(np.asarray(b, np.float64)).permute(0, 3, 1, 2)
    win = torch.from_numpy(ssim_window_f64())
    return ssim_from_moments(x, y, lambda z: one_channel_blur(z, win)).permute(0, 2, 3, 1).numpy()


def eval_frames(test_set, n: int, c: int, seed: int) -> tuple:
    """(pred, gt) of ``n`` frames of 64x64xc: test-set frames as the ground
    truth and a shifted, noisy copy as the prediction (sparse digits and
    saturated strokes, the statistics an eval scores)."""
    rng = np.random.default_rng(seed)
    gt = np.concatenate([test_set[i][1] for i in range(-(-n // 10))])[:n]  # 10 frames each
    gt = np.repeat(gt, c, axis=-1)
    pred = np.clip(np.roll(gt, 2, axis=1) + 0.05 * rng.standard_normal(gt.shape), 0, 1)
    return pred.astype(np.float32), gt


def frame_means(m: np.ndarray) -> np.ndarray:
    """Per-frame, per-channel means of (N, H, W, C) SSIM maps."""
    return m.mean(axis=(1, 2))


def ssim_on_card(dev, test_set) -> dict:
    """Phase 9a: SSIM on the card with TF32 at torch's global default,
    against the CPU in f32 and in f64."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    out = {}
    try:
        for c, n in ((1, SSIM_FRAMES), (3, SSIM_FRAMES // 4)):
            pred, gt = eval_frames(test_set, n, c, seed=9 + c)
            card = ssim_map(torch.from_numpy(pred).to(dev), torch.from_numpy(gt).to(dev))
            card = card.cpu().numpy()
            cpu = ssim_map(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
            f64 = ssim_map_f64(pred, gt)
            frame = frame_means
            err = {"cpu_f32_f64": float(np.abs(cpu - f64).max()),
                   "map_f32": float(np.abs(card - cpu).max()),
                   "map_f64": float(np.abs(card - f64).max()),
                   "frame_f64": float(np.abs(frame(card) - frame(f64)).max()),
                   "max": float(card.max()), "frame_max": float(frame(card).max())}
            # What the TF32 guard is for: the same moments (1) by a cuDNN
            # convolution of one channel with TF32 allowed, and (2) from
            # inputs and window rounded to TF32's 10-bit mantissa, as a TF32
            # tensor core takes them, summed in f32.
            x = torch.from_numpy(pred).to(dev).permute(0, 3, 1, 2)
            y = torch.from_numpy(gt).to(dev).permute(0, 3, 1, 2)
            win = torch.from_numpy(ssim_window_f64().astype(np.float32)).to(dev)
            for label, rnd in (("cudnn_tf32", lambda z: z), ("tf32_inputs", tf32_round)):
                m = ssim_from_moments(x, y, lambda z: one_channel_blur(rnd(z), rnd(win)))
                m = m.permute(0, 2, 3, 1).cpu().numpy()
                err[label] = (float(m.max()), float(np.abs(m - f64).max()),
                              float(np.abs(frame(m) - frame(f64)).max()),
                              float((m > 1).mean()))
            out[c] = err
            print(f"SSIM on the card, {n} frames of 64x64x{c}, cudnn.allow_tf32="
                  f"{torch.backends.cudnn.allow_tf32} (the global default): max |card - CPU "
                  f"f32| {err['map_f32']:.3e}, "
                  f"|card - CPU f64| {err['map_f64']:.3e} (tolerance {SSIM_MAP_TOL:g}) on the "
                  f"maps, {err['frame_f64']:.3e} (tolerance {SSIM_FRAME_TOL:g}) on per-frame "
                  f"means; map max {err['max']:.7f}, per-frame max {err['frame_max']:.6f}; "
                  f"the CPU's own f32 against f64: {err['cpu_f32_f64']:.3e} on the maps")
            for label, what in (("cudnn_tf32", "by a one-channel cuDNN conv, TF32 allowed"),
                                ("tf32_inputs", "from inputs rounded to TF32")):
                top, d_map, d_frame, above = err[label]
                print(f"  the same moments {what}: map max {top:.6f} ({above:.2e} of the "
                      f"values above 1), max |that - CPU f64| {d_map:.3e} on the maps, "
                      f"{d_frame:.3e} on per-frame means")
            check(err["map_f64"] <= SSIM_MAP_TOL and err["map_f32"] <= SSIM_MAP_TOL
                  and err["frame_f64"] <= SSIM_FRAME_TOL, f"SSIM on the card ({c} channels)")
            check(err["max"] <= 1 + 1e-6 and err["frame_max"] <= 1, "SSIM above 1 on the card")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return out


def eval_batch(dataset, b: int, n: int = EVAL_B) -> list:
    """Items ``b*n .. b*n+n-1`` of a map-style dataset."""
    return [dataset[i] for i in range(b * n, (b + 1) * n)]


def evaluator_card_vs_cpu(dev, model, test_set) -> dict:
    """Phase 9b: one B 16 nt_pred-10 batch scored by the Evaluator on the
    card and on the CPU (the full-width seed-0 model, f32, TF32 off); the
    kernel against its plain version at B 16 x 100 steps."""
    items = eval_batch(test_set, 0)
    cond, target = np.stack([c for c, _ in items]), np.stack([t for _, t in items])
    nt_cond = cond.shape[1]
    ev = Evaluator(model)
    plan = card_plan(EVAL_B, *model.t_resnet.flat_params()[0].shape, 1)
    reset_launch_counts()
    card, _, _ = ev.score(cond, target, nt_skip=nt_cond)
    torch.cuda.synchronize()
    launches = dict(mlp_resnet_rollout.variant_launches)
    cpu, _, _ = Evaluator(copy.deepcopy(model).cpu()).score(cond, target, nt_skip=nt_cond)
    print(f"Evaluator.score, card against CPU (f32, TF32 off, full width, seed 0, B {EVAL_B}, "
          f"nt_pred {target.shape[1]}): rollout plan {plan} ({plan.grid // plan.cluster} "
          f"clusters); rollout kernel launches {launches}")
    check(launches == {"cluster": 1, "stream": 0}, "one cluster launch for a B16 score")
    check((plan.variant, plan.cluster, plan.grid // plan.cluster) == ("cluster", 8, 2),
          "the B16 plan is not the cluster kernel at C 8 with 2 clusters")
    errs = {"mse": float(np.max(np.abs(card["mse"] - cpu["mse"]) / cpu["mse"])),
            "psnr": float(np.abs(card["psnr"] - cpu["psnr"]).max()),
            "ssim": float(np.abs(card["ssim"] - cpu["ssim"]).max())}
    tols = {"mse": EVAL_MSE_RTOL, "psnr": EVAL_PSNR_ATOL, "ssim": EVAL_SSIM_ATOL}
    for k in errs:
        print(f"  {k}: card mean {card[k].mean():.6f}, CPU mean {cpu[k].mean():.6f}, worst "
              f"per-sequence difference {errs[k]:.3e} ({'relative' if k == 'mse' else 'absolute'};"
              f" tolerance {tols[k]:g})")
        check(bool(np.isfinite(card[k]).all()) and errs[k] <= tols[k], f"Evaluator {k}")
    with torch.inference_mode():
        t0 = model.encode_t(torch.from_numpy(cond).to(dev)).contiguous()
    params = model.t_resnet.flat_params()
    out = mlp_resnet_rollout(t0, params, N_FORECAST)
    ref = mlp_resnet_rollout_reference(t0, params, N_FORECAST)
    rel = step_rel_err(out, ref)
    print(f"  cluster kernel vs plain at B {EVAL_B} x {N_FORECAST} steps: worst step-relative "
          f"error {rel:.3e} (tolerance {ROLLOUT_REL_TOL:g}), max abs "
          f"{float((out - ref).abs().max()):.3e} at max |t| {float(ref.abs().max()):.3e}")
    check(rel <= ROLLOUT_REL_TOL, "cluster kernel disagrees with plain at B16")
    return {"launches": launches["cluster"], "plan": plan, "rel": rel,
            "abs": float((out - ref).abs().max()), "t0": t0, "params": params}


def write_test_set(ctx) -> str:
    """Phase 9's product ``ctx.test_set``: synthetic test digits written as
    idx files beside phase 8's training digits, and the test set
    ``make_test_set`` makes of them.  Returns the data directory."""
    data_dir = ctx.digits.data_dir
    t = time.perf_counter()
    digits = synthetic_digits(N_TEST_DIGITS, seed=1)
    write_idx_images(os.path.join(data_dir, "t10k-images-idx3-ubyte"), digits)
    write_idx_labels(os.path.join(data_dir, "t10k-labels-idx1-ubyte"),
                     (np.arange(N_TEST_DIGITS) % 10).astype(np.uint8))
    path = make_test_set(data_dir, seq_len=TEST_SEQ_LEN, seed=42, digits=2)
    print(f"phase 9: {N_TEST_DIGITS} synthetic test digits and the test set "
          f"({N_TEST_DIGITS // 2} sequences x {TEST_SEQ_LEN} frames, "
          f"{os.path.getsize(path) / 1e6:.1f} MB compressed) in {time.perf_counter() - t:.1f} s")
    return data_dir


def eval_clis(ctx) -> str:
    """Phase 9c, the product ``ctx.eval_archive``: both protocols through
    their CLIs, in-process, on the card, on phase 8b's bf16 checkpoint and
    ``ctx.test_set``.  The t95 run leaves its archive in the checkpoint's
    directory, which is returned."""
    xp, data_dir = ctx.checkpoint.xp, ctx.test_set
    with open(os.path.join(xp, "params.json")) as f:
        precision = json.load(f)["precision"]
    for key, cli, flags in (
            ("mnist_t10", cli_test_mnist, ["--nt_pred", "10"]),
            ("mnist_swap_t10", cli_test_swap, ["--nt_pred", "10"]),
            ("mnist_t95", cli_test_mnist, ["--nt_pred", "95", "--max_batches",
                                           str(T95_MAX_BATCHES)])):
        argv = ["--xp_dir", xp, "--data_dir", data_dir, *flags,
                "--archive_cap", str(ARCHIVE_CAP)]
        print(f"eval CLI ({precision} checkpoint of phase 8b): python -m "
              f"{cli.__name__} " + " ".join(argv))
        reset_launch_counts()
        t = time.perf_counter()
        means = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(mlp_resnet_rollout.variant_launches)
        record = json.load(open(os.path.join(xp, "evals.json")))[key]
        n_seq = EVAL_B * T95_MAX_BATCHES if key == "mnist_t95" else N_TEST_DIGITS // 2
        print(f"  {n_seq} sequences in {wall:.1f} s ({n_seq / wall:.1f} sequences/s, load "
              f"included); means {means}; rollout launches {launches}; evals.json "
              f"max_batches {record.get('max_batches')}")
        check(all(np.isfinite(v) for v in means.values()), f"{key}: non-finite means")
        check(0 < means["ssim"] <= 1, f"{key}: SSIM outside (0, 1]")
        check(launches == {"cluster": 0, "stream": 0},
              f"{key}: the {precision} path launched the rollout kernel")
        check(record["mse"] == means["mse"] and record.get("max_batches") == (
            T95_MAX_BATCHES if key == "mnist_t95" else None), f"{key}: evals.json record")
    return xp


def t95_ssim_by_step(dev, xp: str) -> None:
    """Phase 9c: the SSIM of each step of the bf16 checkpoint's t95 forecast
    (the CLI's archive: its first ARCHIVE_CAP sequences, as uint8) beside the
    step's share of predicted pixels at 0 or 1, and their correlation; the
    archive's mean SSIM beside the CLI's, which scored the float frames."""
    with np.load(os.path.join(xp, "predictions.npz")) as z:
        pred = z["predictions"]
    with np.load(os.path.join(xp, "gt.npz")) as z:
        gt = z["gt"]
    saturated = ((pred == 0) | (pred == 255)).mean(axis=(0, 2, 3, 4))
    with torch.inference_mode():
        ssim = ssim_per_frame(torch.from_numpy(pred).to(dev).float() / 255,
                              torch.from_numpy(gt).to(dev).float() / 255)
    by_step = ssim.mean(dim=(0, 2)).cpu().numpy()
    record = json.load(open(os.path.join(xp, "evals.json")))["mnist_t95"]
    print(f"t95 forecast of the bf16 checkpoint, {pred.shape[0]} archived sequences x "
          f"{pred.shape[1]} steps: mean SSIM of the uint8 archive {by_step.mean():.4f} (the "
          f"CLI's, of the float frames: {record['ssim']:.4f})")
    print("  step: SSIM, share of predicted pixels at 0 or 1 -- " + ", ".join(
        f"{k + 1}: {by_step[k]:.4f}, {saturated[k]:.4f}"
        for k in sorted({0, 1, 2, 4, 9, *range(19, len(by_step), 10), len(by_step) - 1})))
    corr = float(np.corrcoef(by_step, saturated)[0, 1])
    print(f"  correlation of the per-step SSIM with the saturated share: {corr:.4f}; SSIM "
          f"first 10 steps {by_step[:10].mean():.4f}, last 10 {by_step[-10:].mean():.4f}; "
          f"saturated first 10 {saturated[:10].mean():.4f}, last 10 {saturated[-10:].mean():.4f}")
    check(bool(np.isfinite(by_step).all()), "non-finite t95 SSIM by step")


def eval_f32_bundle(model, cfg, data_dir: str, work: str) -> dict:
    """Phase 9c, the f32 bundle: the same protocols through
    ``evaluate(model_bundle=...)`` on the full-width seed-0 model; one
    cluster launch for every kernel-bearing call."""
    xp = os.path.join(work, "eval_f32")
    os.makedirs(xp)
    launches = {}
    for key, evaluate, nt_pred in (("mnist_t10", eval_mnist.evaluate, 10),
                                   ("mnist_swap_t10", eval_swap.evaluate, 10),
                                   ("mnist_t95", eval_mnist.evaluate, 95)):
        n_batches = BUNDLE_MAX_BATCHES[key]
        # score (or score_swap) once a batch; the Moving MNIST protocol also
        # forecasts the content swap of every archived batch
        archived = -(-BUNDLE_ARCHIVE_CAP // EVAL_B) if evaluate is eval_mnist.evaluate else 0
        reset_launch_counts()
        t = time.perf_counter()
        means = evaluate(xp, data_dir, nt_pred, max_batches=n_batches, model_bundle=(model, cfg),
                         archive_cap=BUNDLE_ARCHIVE_CAP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches[key] = dict(mlp_resnet_rollout.variant_launches)
        print(f"evaluate(model_bundle=f32 seed-0 model) {key}, {n_batches} batches of "
              f"{EVAL_B}: {wall:.1f} s; means {means}; rollout launches {launches[key]} "
              f"(kernel-bearing calls: {n_batches} scores + {archived} swap forecasts)")
        check(all(np.isfinite(v) for v in means.values()) and 0 < means["ssim"] <= 1,
              f"f32 {key} means")
        check(launches[key] == {"cluster": n_batches + archived, "stream": 0},
              f"f32 {key}: one cluster launch a kernel-bearing call")
    return launches


def eval_resume(xp: str, data_dir: str, evaluate, protocol: str, results: str,
                **kw) -> None:
    """Phase 9d (and 11e): ``evaluate`` on the bf16 checkpoint killed after
    batch 2 and resumed, against the uninterrupted run, under
    cudnn.deterministic: the means and the per-sequence rows bitwise."""
    torch.backends.cudnn.deterministic = True
    try:
        full = evaluate(xp, data_dir, **kw)
        with np.load(os.path.join(xp, results)) as z:
            full_rows = {k: z[k] for k in z.files}
        real_add = eval_common.EvalProgress.add

        def dying_add(self, b, rows):
            real_add(self, b, rows)
            if b + 1 == RESUME_KILL_AFTER:
                raise RuntimeError("killed after batch 2")

        eval_common.EvalProgress.add = dying_add
        try:
            evaluate(xp, data_dir, **kw)
            check(False, "the killed eval did not stop")
        except RuntimeError as e:
            check("killed" in str(e), f"the killed eval failed otherwise: {e}")
        finally:
            eval_common.EvalProgress.add = real_add
        check(os.path.exists(os.path.join(xp, f"{protocol}.progress.npz")), "no progress file")
        resumed = evaluate(xp, data_dir, resume=True, **kw)
        with np.load(os.path.join(xp, results)) as z:
            rows_equal = full_rows.keys() == set(z.files) and all(
                full_rows[k].tobytes() == z[k].tobytes() for k in z.files)
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"eval resume on the card ({protocol}, cudnn.deterministic, {kw['max_batches']} "
          f"batches, killed after batch {RESUME_KILL_AFTER}): uninterrupted {full}, resumed "
          f"{resumed}; bitwise equal: {resumed == full}, per-sequence rows: {rows_equal}")
    check(resumed == full and rows_equal, "the resumed eval differs from the uninterrupted one")


def eval_idle(models: dict, data_dir: str) -> None:
    """Phase 9e: per protocol and model, the scoring loop (host batch and
    score) under the profiler: its sequences/s and the device's idle share,
    at the eval batch."""
    images, _ = load_mnist(data_dir, train=False)
    sets = {nt: MovingMNIST.make_dataset(data_dir, 64, 5, 5 + nt, 4, True, 2, train=False)
            for nt in (10, 95)}
    swap_set = SwapDataset(data_dir, 15, 5, 2, np.random.RandomState(1), images=images)
    for key, nt in (("mnist_t10", 10), ("mnist_swap_t10", 10), ("mnist_t95", 95)):
        swap = key.startswith("mnist_swap")

        def host_batch(b, nt=nt, swap=swap):
            items = eval_batch(sets[nt], b)
            cond = np.stack([c for c, _ in items])
            target = np.stack([t for _, t in items])
            if not swap:
                return cond, target
            sw = eval_batch(swap_set, b)
            return (np.stack([it[0] for it in sw]), cond,
                    np.stack([it[3] for it in sw]))

        for name, model in models.items():
            ev = Evaluator(model)
            batch_ids = itertools.cycle(range(EVAL_TIMING_BATCHES))

            def loop(ev=ev, swap=swap):
                b = host_batch(next(batch_ids))
                return ev.score_swap(*b, nt_skip=5) if swap else ev.score(*b, nt_skip=5)

            loop()
            prof = device_profile(loop, EVAL_TIMING_BATCHES)
            print(f"  {key} [{name}], B {EVAL_B}, the loop (host batch + score): "
                  f"{prof['wall_ms']:.2f} ms a batch = {EVAL_B / prof['wall_ms'] * 1e3:.1f} "
                  f"sequences/s, device busy {prof['busy_ms']:.3f} ms, idle {prof['idle']:.1%} "
                  f"(profiler)")


def evaluation(ctx) -> dict:
    """Phase 9: the Moving MNIST evaluation on the card, of phase 3's seed-0
    f32 model and phase 8b's bf16 checkpoint, on ``ctx.test_set``.  Returns
    the eval launches of the kernel, its B 16 figures and its times at the
    t10 eval's rollout shapes."""
    dev, model, cfg = ctx.dev, ctx.seed0.model, ctx.seed0.cfg
    data_dir = ctx.test_set
    test_set = MovingMNIST.make_dataset(data_dir, 64, cfg.nt_cond, cfg.nt_cond + 10, 4, True,
                                        cfg.n_object, train=False)
    check(len(test_set) == N_TEST_DIGITS // 2, "test-set size")
    ssim = ssim_on_card(dev, test_set)
    b16 = evaluator_card_vs_cpu(dev, model, test_set)
    del test_set
    xp = ctx.eval_archive
    t95_ssim_by_step(dev, xp)
    bundle = eval_f32_bundle(model, cfg, data_dir, ctx.work)
    eval_resume(xp, data_dir, eval_mnist.evaluate, "mnist_t10", "results.npz", nt_pred=10,
                max_batches=RESUME_BATCHES, save_arrays=False, device=dev)
    print(f"eval timing on {ctx.smi} (TF32 off)")
    bf16_model, _ = load_for_eval(xp, device=dev)
    eval_idle({"bf16 checkpoint": bf16_model, "f32 seed 0": model}, data_dir)
    t0, params = b16["t0"], b16["params"]
    print(f"both kernels at the t10 eval's rollout (B {EVAL_B} x {EVAL_ROLLOUT_STEPS} steps):")
    turns = rollout_turns(ctx, t0, params, EVAL_ROLLOUT_STEPS, {
        "cluster": card_plan(EVAL_B, t0.shape[1], params[0].shape[1], 1),
        "stream": card_plan(EVAL_B, t0.shape[1], params[0].shape[1], 1, variant="stream")})
    return {"b16": b16, "bundle": bundle, "ssim": ssim, "turns": turns}


# -- phase 10: WaveEq -----------------------------------------------------------

# The recipes of the reference README (tests/test_recipes.py:28-36), cut to
# WAVE_EPOCHS x WAVE_STEPS; bf16, the train CLI's default precision.
WAVE_RECIPES = {
    "wave": ("--data wave --nt_cond 5 --nt_pred 20 --batch_size 128 --code_size_t 32 "
             "--code_size_s 32 --gain_resnet 0.71 --offset 5 --n_blocks 3 --mixing mul "
             "--architecture mlp --enc_hidden_size 1200 --dec_hidden_size 1200 "
             "--dec_n_layers 4 --lamb_ae 1").split(),
    "wave_partial": ("--data wave_partial --nt_cond 5 --nt_pred 20 --batch_size 128 "
                     "--code_size_t 32 --code_size_s 32 --gain_resnet 0.71 --offset 5 "
                     "--n_blocks 3 --mixing mul --architecture mlp --enc_hidden_size 2400 "
                     "--dec_hidden_size 150 --lamb_ae 1").split(),
}
WAVE_SIZE, WAVE_SEQ_LEN, WAVE_SEED = 300, 300, 42  # gen_wave's defaults: the canonical data
WAVE_SIM_SEQS = 2
# simulate_wave, max |error| of a frame over its max |w|.  Card against the
# port on the CPU: the same elementwise ATen ops in the same order, no
# reduction, so only the last bits of exp (and a contraction inside one
# kernel) can differ; the port against the JAX package on the CPU, whose
# XLA contracts products and sums, measures 1.2e-5.  Against the f64 RK4:
# f32 rounds 299 small increments; 2.5e-4 measured on the CPU, for the JAX
# package's f32 as for the port's.
WAVE_SIM_RTOL, WAVE_SIM_F64_RTOL = 1e-4, 1e-3
WAVE_EPOCHS, WAVE_STEPS = 2, 20
# The CLI's loss at its last logged step (40) against its first (step 5), a
# fresh batch every step: it falls, not steadily (the T regularizer grows
# while the forecast error falls).  Measured on an H100: 0.751 on wave
# (1.443 -> 1.084, with 1.279 at step 35), 0.709 on wave_partial.
WAVE_LOSS_FALL = 1.0
WAVE_RESUME_EPOCHS, WAVE_RESUME_STEPS, WAVE_RESUME_STOP_AFTER = 2, 6, 8
WAVE_EVAL_B = 256           # cli.test_wave's default batch
WAVE_CPU_BATCHES = 2        # the f32 eval on the CPU, against the card: 512 windows
WAVE_ROLLOUT_STEPS = 45     # nt_cond 5 + the protocol's 40 (offset 5)
# Per-sequence MSE@t+40 of the f32 seed-0 model, card against CPU, TF32 off:
# the limit phase 9b holds the Evaluator to.
WAVE_MSE_RTOL = 1e-4


def wave_rk4_f64(c: np.ndarray, f0: np.ndarray, seq_len: int, tableau: str,
                 dt: float = 1e-3) -> np.ndarray:
    """(N, seq_len, 64, 64) waves by RK4 with every operation in f64: numpy,
    written out apart from ``data/wave_eq.py`` (the reference's physics:
    5-point stencil on [2, 62), source f0 exp(-20 t) in the r 5 disk)."""
    c = np.asarray(c, np.float64)[:, None, None]
    f0 = np.asarray(f0, np.float64)[:, None, None]
    jj, ii = np.meshgrid(np.arange(64), np.arange(64))
    mask = (((jj - 32) ** 2 + (ii - 32) ** 2) < 25).astype(np.float64)

    def lap(w):
        out = np.zeros_like(w)
        k2, k1, k0 = -1 / 12, 4 / 3, -5 / 2
        out[..., :, 2:-2] += (k2 * w[..., :, 4:] + k1 * w[..., :, 3:-1] + k0 * w[..., :, 2:-2]
                              + k1 * w[..., :, 1:-3] + k2 * w[..., :, :-4])
        out[..., 2:-2, :] += (k2 * w[..., 4:, :] + k1 * w[..., 3:-1, :] + k0 * w[..., 2:-2, :]
                              + k1 * w[..., 1:-3, :] + k2 * w[..., :-4, :])
        return out

    def f(t, w, wd):
        return wd, c * c * lap(w) + f0 * np.exp(-20 * t) * mask

    w = np.zeros((c.shape[0], 64, 64))
    wd = np.zeros_like(w)
    frames = [w]
    for s in range(seq_len - 1):
        t = s * dt
        k1 = f(t, w, wd)
        if tableau == "classic":
            k2 = f(t + dt / 2, w + dt / 2 * k1[0], wd + dt / 2 * k1[1])
            k3 = f(t + dt / 2, w + dt / 2 * k2[0], wd + dt / 2 * k2[1])
            k4 = f(t + dt, w + dt * k3[0], wd + dt * k3[1])
            w, wd = (w + dt / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0]),
                     wd + dt / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1]))
        else:
            k2 = f(t + dt / 3, w + dt / 3 * k1[0], wd + dt / 3 * k1[1])
            k3 = f(t + 2 * dt / 3, w + dt * (k2[0] - k1[0] / 3), wd + dt * (k2[1] - k1[1] / 3))
            k4 = f(t + dt, w + dt * (k1[0] - k2[0] + k3[0]), wd + dt * (k1[1] - k2[1] + k3[1]))
            w, wd = (w + dt / 8 * (k1[0] + 3 * k2[0] + 3 * k3[0] + k4[0]),
                     wd + dt / 8 * (k1[1] + 3 * k2[1] + 3 * k3[1] + k4[1]))
        frames.append(w)
    return np.stack(frames, axis=1)


def frame_rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    """max over frames of max |out - ref| / max |ref| of that frame (frames
    that are all zero in ``ref`` must be all zero in ``out``)."""
    diff = np.abs(out - ref).max(axis=(-1, -2))
    scale = np.abs(ref).max(axis=(-1, -2))
    if (diff[scale == 0] > 0).any():
        return float("inf")
    return float((diff[scale > 0] / scale[scale > 0]).max())


def wave_simulator(dev) -> None:
    """Phase 10a: simulate_wave on the card against the CPU and against f64."""
    f0s, cs = wave_eq.draw_parameters(WAVE_SIM_SEQS, WAVE_SEED)
    for tableau in ("38", "classic"):
        t = time.perf_counter()
        card = wave_eq.simulate_wave(cs, f0s, seq_len=WAVE_SEQ_LEN, tableau=tableau, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        card = card.cpu().numpy()
        cpu = wave_eq.simulate_wave(cs, f0s, seq_len=WAVE_SEQ_LEN, tableau=tableau,
                                    device="cpu").numpy()
        f64 = wave_rk4_f64(cs, f0s, WAVE_SEQ_LEN, tableau)
        errs = {"cpu": frame_rel_err(card, cpu), "f64": frame_rel_err(card, f64),
                "cpu_f64": frame_rel_err(cpu, f64)}
        print(f"simulate_wave on the card, {WAVE_SIM_SEQS} sequences x {WAVE_SEQ_LEN} steps of "
              f"64x64, tableau {tableau}: {card_s:.3f} s; error relative to each frame's max: "
              f"card against CPU {errs['cpu']:.3e} (tolerance {WAVE_SIM_RTOL:g}; bitwise "
              f"{card.tobytes() == cpu.tobytes()}), card against f64 RK4 {errs['f64']:.3e} "
              f"(tolerance {WAVE_SIM_F64_RTOL:g}); the CPU's own f32 against f64 "
              f"{errs['cpu_f64']:.3e}; max |w| {np.abs(card).max():.4e}")
        check(card.shape == (WAVE_SIM_SEQS, WAVE_SEQ_LEN, 64, 64)
              and bool(np.isfinite(card).all()), "simulate_wave shape or values")
        check(errs["cpu"] <= WAVE_SIM_RTOL and errs["f64"] <= WAVE_SIM_F64_RTOL,
              f"simulate_wave on the card ({tableau})")


def wave_dataset(dev, data_dir: str) -> None:
    """Phase 10b: the canonical dataset generated on the card, and its pixels."""
    t = time.perf_counter()
    wave_eq.generate_dataset(data_dir, WAVE_SIZE, WAVE_SEQ_LEN, seed=WAVE_SEED, device=dev)
    gen_s = time.perf_counter() - t
    rng = np.random.RandomState(WAVE_SEED)  # the reference's loop, gen_wave.py:121-130
    host = np.array([(rng.uniform(1, 30), rng.uniform(300, 400)) for _ in range(WAVE_SIZE)],
                    np.float32)
    f0s, cs = wave_eq.draw_parameters(WAVE_SIZE, WAVE_SEED)
    files = sorted(os.listdir(os.path.join(data_dir, "data")))
    size = sum(os.path.getsize(os.path.join(data_dir, "data", f)) for f in files)
    stored = np.array([np.load(os.path.join(data_dir, "data", f"homogenous_wave{i}.npz"))["c"]
                       for i in range(WAVE_SIZE)], np.float32)
    wave_eq.generate_pixels(data_dir)
    print(f"generate_dataset on the card: {WAVE_SIZE} sequences x {WAVE_SEQ_LEN} frames, seed "
          f"{WAVE_SEED}, {len(files)} npz files, {size / 1e9:.3f} GB, in {gen_s:.1f} s (integration "
          f"on the card and the writes); f0 and c byte-equal to a host RandomState"
          f"({WAVE_SEED}): {f0s.tobytes() == host[:, 0].tobytes()} and "
          f"{cs.tobytes() == host[:, 1].tobytes()}; the files' c fields: "
          f"{stored.tobytes() == cs.tobytes()}")
    check(len(files) == WAVE_SIZE and f0s.tobytes() == host[:, 0].tobytes()
          and cs.tobytes() == host[:, 1].tobytes() and stored.tobytes() == cs.tobytes(),
          "WaveEq draws or files")


def wave_config(kind: str, data_dir: str, **kw) -> ExperimentConfig:
    argv = WAVE_RECIPES[kind] + ["--xp_dir", "", "--data_dir", data_dir]
    cfg = config_from_args(build_parser().parse_args(argv))
    return dataclasses.replace(cfg, **kw).validate()


def wave_sampler(dev, data_dir: str) -> None:
    """Phase 10c: the recipe's train split on the card, windows of the same
    draws gathered on the card and on the CPU."""
    cfg = wave_config("wave", data_dir)
    t = time.perf_counter()
    host = registry.make_train_dataset(cfg)
    load_s = time.perf_counter() - t
    gen = DeviceWaveEq.from_host_dataset(host, device=dev)
    cpu_gen = DeviceWaveEq.from_host_dataset(host, device="cpu")
    rng = torch.Generator(device=dev)
    rng.manual_seed(step_seed(cfg.seed, DATA_SALT, 0))
    draws = gen.draw(rng, cfg.batch_size)
    card = gen.gather(*draws).cpu()
    cpu = cpu_gen.gather(*(d.cpu() for d in draws))
    same = card.numpy().tobytes() == cpu.numpy().tobytes()
    mb = gen.flat.numel() * 4 / 1e6
    print(f"DeviceWaveEq: the train split ({gen.n_seq} sequences x {gen.nt} frames, "
          f"{len(gen)} windows of {gen.seq_len}) loaded in {load_s:.1f} s, {mb:.1f} MB on the "
          f"card; one B {cfg.batch_size} batch of the same draws, card == CPU bitwise: {same}")
    check(same and tuple(card.shape) == (cfg.batch_size, gen.seq_len, 64, 64, 1),
          "WaveEq windows differ between the card and the CPU")


def wave_train(dev, data_dir: str, work: str) -> dict:
    """Phase 10d: both recipes through the train CLI; a mid-epoch resume.
    Returns {kind: xp_dir}."""
    xps = {}
    for kind, flags in WAVE_RECIPES.items():
        xp = os.path.join(work, kind)
        argv = ["--xp_dir", xp, "--data_dir", data_dir, *flags, "--seed", "0", "--epochs",
                str(WAVE_EPOCHS), "--steps_per_epoch", str(WAVE_STEPS), "--log_every", "5"]
        print("train CLI: python -m spatiotemporal_variable_separation_tpu_torch.cli.main "
              + " ".join(argv))
        reset_launch_counts()
        state = cli_main.main(argv)
        launches = dict(mlp_resnet_rollout.variant_launches)
        rows = metrics_rows(xp)
        losses = [(int(r["step"]), float(r["loss"])) for r in rows if not r["samples_per_sec"]]
        epochs = [float(r["samples_per_sec"]) for r in rows if r["samples_per_sec"]]
        cfg = ExperimentConfig.from_json_file(os.path.join(xp, "params.json"))
        print(f"  {kind}: steps {state.step}, precision {cfg.precision}, rollout kernel launches "
              f"while training {launches}; loss by step: "
              + ", ".join(f"{s}: {v:.4f}" for s, v in losses))
        check(state.step == WAVE_EPOCHS * WAVE_STEPS and cfg.precision == "bf16",
              f"{kind}: CLI steps or precision")
        check(launches == {"cluster": 0, "stream": 0}, f"{kind}: training launched the kernel")
        check(len(losses) >= 2 and all(np.isfinite(v) for _, v in losses), f"{kind}: loss rows")
        print(f"  last/first logged loss {losses[-1][1] / losses[0][1]:.4f} (must be below "
              f"{WAVE_LOSS_FALL:g})")
        check(losses[-1][1] < WAVE_LOSS_FALL * losses[0][1], f"{kind}: the loss did not fall")
        for e, sps in enumerate(epochs):
            print(f"  epoch {e}: {sps:.1f} samples/s = {cfg.batch_size / sps * 1e3:.3f} ms/step"
                  + (" (includes the first step's warm-up)" if e == 0 else ""))
        check(len(epochs) == WAVE_EPOCHS, f"{kind}: one samples/s row an epoch")
        xps[kind] = xp

    train_resume_bitwise(dev, "wave", lambda run: wave_config(
        "wave", data_dir, xp_dir=os.path.join(work, f"wave_resume_{run}"), seed=0,
        epochs=WAVE_RESUME_EPOCHS, steps_per_epoch=WAVE_RESUME_STEPS),
        WAVE_RESUME_EPOCHS * WAVE_RESUME_STEPS, WAVE_RESUME_STOP_AFTER)
    return xps


def train_resume_bitwise(dev, label: str, make_cfg, total_steps: int, stop_after: int,
                         device_gen=None) -> None:
    """Phases 10d, 11d, 12c and 13c: run A trains uninterrupted; run B is
    stopped by a SIGTERM after step ``stop_after`` is logged, then resumed;
    under cudnn.deterministic both must end bitwise equal (params, BatchNorm
    statistics, Adam state, the logged loss strings).  ``make_cfg(run)``
    gives each run's config; ``device_gen``, a sampler to train from in
    place of the registry's."""
    torch.backends.cudnn.deterministic = True
    states, losses = {}, {}
    try:
        for run in ("a", "b"):
            cfg = make_cfg(run)
            os.makedirs(cfg.xp_dir)
            cfg.save(os.path.join(cfg.xp_dir, "params.json"))
            if run == "b":
                def stop(msg):  # loss lines lag one boundary: after step N is logged
                    if f"step {stop_after}:" in msg:
                        os.kill(os.getpid(), signal.SIGTERM)
                stopped = run_training(cfg, device=dev, log_every=1, log_fn=stop,
                                       device_gen=device_gen)
                check(stopped.step == stop_after + 1, f"{label} run B did not stop")
            states[run] = run_training(cfg, device=dev, log_every=1, log_fn=lambda s: None,
                                       resume=run == "b", device_gen=device_gen)
            losses[run] = {int(r["step"]): r["loss"] for r in metrics_rows(cfg.xp_dir)}
    finally:
        torch.backends.cudnn.deterministic = False
    ta, tb = train_state_tensors(states["a"]), train_state_tensors(states["b"])
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    shared = sorted(set(losses["a"]) & set(losses["b"]))
    loss_differ = [s for s in shared if losses["a"][s] != losses["b"][s]]
    print(f"{label} resume on the card (cudnn.deterministic, {total_steps} steps, SIGTERM after "
          f"step {stop_after}): steps {states['a'].step} and {states['b'].step}; {len(differ)} "
          f"of {len(ta)} tensors (params, BatchNorm statistics, Adam state) differ "
          f"{differ[:3]}; {len(loss_differ)} of {len(shared)} shared loss strings differ")
    check(states["a"].step == states["b"].step == total_steps and not differ
          and not loss_differ, f"the resumed {label} run is not bitwise")


def wave_eval_clis(xps: dict, data_dir: str, n_seq: int) -> dict:
    """Phase 10e: cli.test_wave on both bf16 checkpoints, the whole test split
    (``n_seq`` windows)."""
    out = {}
    for kind, xp in xps.items():
        argv = ["--xp_dir", xp, "--data_dir", data_dir]
        print(f"eval CLI (bf16 checkpoint of 10d): python -m {cli_test_wave.__name__} "
              + " ".join(argv))
        reset_launch_counts()
        t = time.perf_counter()
        means = cli_test_wave.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(mlp_resnet_rollout.variant_launches)
        record = json.load(open(os.path.join(xp, "evals.json")))["wave"]
        print(f"  {kind}: mse_t40 {means['mse_t40']:.6f}; {n_seq} windows in {wall:.1f} s "
              f"({n_seq / wall:.1f} windows/s, test-split load included); rollout launches "
              f"{launches}; evals.json {record}")
        check(np.isfinite(means["mse_t40"]) and record["mse_t40"] == means["mse_t40"]
              and "max_batches" not in record, f"{kind}: mse_t40 or evals.json")
        check(launches == {"cluster": 0, "stream": 0}, f"{kind}: the bf16 eval launched a kernel")
        out[kind] = (n_seq, wall, means["mse_t40"])
    return out


def wave_eval_f32(ctx, data_dir: str, work: str, test: wave_eq.WaveEq) -> dict:
    """Phase 10f: the f32 seed-0 WaveEq model through the streaming kernel;
    the Evaluator on the card against the CPU; the kernel against plain at
    the protocol's rollout shape, on windows of the test split ``test``,
    and timed there."""
    dev = ctx.dev
    cfg = wave_config("wave", data_dir, precision="f32", nt_pred=eval_wave.NT_PRED, seed=0)
    model = build_separable_network(cfg, dev, torch.Generator().manual_seed(0)).eval()
    xp = os.path.join(work, "wave_f32")
    os.makedirs(xp)
    n_items = len(test)
    n_batches = -(-n_items // WAVE_EVAL_B)
    reset_launch_counts()
    t = time.perf_counter()
    means = eval_wave.evaluate(xp, data_dir, WAVE_EVAL_B, model_bundle=(model, cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(mlp_resnet_rollout.variant_launches)
    plan = card_plan(WAVE_EVAL_B, cfg.code_size_t, cfg.res_hidden_size, cfg.n_blocks)
    smem = {(c, r): cluster_smem_bytes(cfg.code_size_t, cfg.res_hidden_size, cfg.n_blocks, c, r)
            for c, r in ((16, 8), (16, 4))}
    print(f"evaluate(model_bundle=f32 seed-0 WaveEq model, full width), {n_items} windows in "
          f"{n_batches} batches of {WAVE_EVAL_B}: {wall:.1f} s; mse_t40 {means['mse_t40']:.6f}; "
          f"rollout plan {plan_text(plan)}; launches {launches} (one a batch); a resident "
          f"cluster of 16 would need "
          f"{smem[16, 8]} bytes at 8 rows, {smem[16, 4]} at 4, over the {SMEM_LIMIT} a CTA has")
    check(np.isfinite(means["mse_t40"]), "f32 wave mse_t40")
    check(plan.variant == "stream" and plan.waves == 1,
          f"the wave plan {plan} is not the streaming kernel in one wave")
    check(launches == {"cluster": 0, "stream": n_batches}, "one streaming launch a wave batch")

    card = eval_wave.frame_mses(xp, data_dir, model, cfg, WAVE_EVAL_B, WAVE_CPU_BATCHES)
    cpu = eval_wave.frame_mses(xp, data_dir, copy.deepcopy(model).cpu(), cfg, WAVE_EVAL_B,
                               WAVE_CPU_BATCHES)
    seq_err = float(np.max(np.abs(card.mean(1) - cpu.mean(1)) / cpu.mean(1)))
    frame_err = float(np.max(np.abs(card - cpu) / cpu))
    print(f"  Evaluator card against CPU (f32, TF32 off), {len(cpu)} windows: per-sequence MSE "
          f"worst relative {seq_err:.3e} (tolerance {WAVE_MSE_RTOL:g}), per frame {frame_err:.3e}; "
          f"means {card.mean():.6f} and {cpu.mean():.6f}")
    check(card.shape == cpu.shape == (WAVE_CPU_BATCHES * WAVE_EVAL_B, eval_wave.NT_PRED)
          and seq_err <= WAVE_MSE_RTOL, "the wave Evaluator, card against CPU")

    cond = np.stack([test[i][0] for i in range(WAVE_EVAL_B)])
    with torch.inference_mode():
        t0 = model.encode_t(torch.from_numpy(cond).to(dev)).contiguous()
    params = model.t_resnet.flat_params()
    timed = card_plan(*t0.shape, params[0].shape[1], len(params) // 6)
    check(timed == plan, f"the timed plan {timed} is not the eval's {plan}")
    print("  the streaming kernel at the eval's plan and rollout (t0 from the test split):")
    turns = rollout_turns(ctx, t0, params, WAVE_ROLLOUT_STEPS, {"stream": timed})
    return {"launches": launches, "turns": turns}


def wave_phase(ctx) -> dict:
    """Phase 10: WaveEq and WaveEq-100 on the card, in a working directory of
    its own.  Returns 10f's launches and kernel figures."""
    dev = ctx.dev
    with tempfile.TemporaryDirectory(dir=ctx.work) as work:
        data_dir = os.path.join(work, "wave_data")
        wave_simulator(dev)
        wave_dataset(dev, data_dir)
        wave_sampler(dev, data_dir)
        xps = wave_train(dev, data_dir, work)
        test = wave_eq.WaveEq(data_dir, 5, WAVE_ROLLOUT_STEPS, train=False)  # both recipes' nt_cond
        wave_eval_clis(xps, data_dir, len(test))
        return wave_eval_f32(ctx, data_dir, work, test)


# -- phase 11: 3D Chairs --------------------------------------------------------

# The reference README's chairs recipe (tests/test_recipes.py:18-19,
# docs/RESULTS.md:20) at full width: ResNet-18 encoders, the DCGAN decoder, S
# code 128 (the default), T code 10, a 1-block MLP-ResNet at H 512, 5+10 frames
# of 64x64x3, B 128; bf16, the train CLI's default precision.
CHAIRS_RECIPE = ("--data chairs --architecture resnet --decoder_architecture dcgan "
                 "--code_size_t 10 --gain_resnet 0.71 --lamb_ae 1 --lamb_s 1 --nt_cond 5 "
                 "--nt_pred 10 --offset 5 --batch_size 128").split()
CHAIRS_OBJECTS = 100        # half gen_synthetic's default (200, the JAX records' stand-in)
CHAIRS_EPOCHS, CHAIRS_STEPS = 2, 20
# The CLI's loss at its last logged step (40) against its first (step 5), a
# fresh batch every step: it must fall.
CHAIRS_LOSS_FALL = 1.0
CHAIRS_RESUME_EPOCHS, CHAIRS_RESUME_STEPS, CHAIRS_RESUME_STOP_AFTER = 2, 6, 8
CHAIRS_HOST_STEPS = 4
CHAIRS_EVAL_B = 16          # cli.test_chairs_disentanglement's default batch
CHAIRS_TEST_SEQS = 15 * 62  # the test split of 100 objects (15%), 62 start views each
CHAIRS_CPU_BATCHES = 2
# An encoder, decoder or integrator, card against CPU, relative to the
# output's max |.| (phases 11b, 12a, 13a).  f32 with TF32 off: sums in
# another order (cuDNN against oneDNN), ~1e-6.  bf16: both round every conv
# to bf16 at other places; the CPU tests hold the port to flax's bf16 within
# 2e-2 in eval mode and 0.1 in train mode, where each channel is renormalized
# by its batch statistics (tests/test_torch_resnet18.py).
ENC_F32_TOL = 1e-4
ENC_BF16_TOL = {False: 2e-2, True: 0.1}


def chairs_kernel_cases(dev) -> dict:
    """Phase 11a, in phase 3's cases: the chairs integrator's shapes (code
    10, H 512, 1 block, orthogonal init at gain 0.71) at the eval's B 16 x 15
    steps and at B 64 x 100, both planned on the cluster kernel at C 8."""
    gen = torch.Generator().manual_seed(11)
    resnet = MLPResnet(10, 1, 512, init_gain=0.71, generator=gen).to(dev)
    return {f"chairs B{b} code10 H512 1 block {n} steps": (
        torch.randn(b, 10, generator=gen).to(dev), resnet.flat_params(), n, ("cluster", 8))
        for b, n in ((CHAIRS_EVAL_B, 15), (B, N_FORECAST))}


def chairs_config(data_dir: str, **kw) -> ExperimentConfig:
    argv = CHAIRS_RECIPE + ["--xp_dir", "", "--data_dir", data_dir]
    cfg = config_from_args(build_parser().parse_args(argv))
    return dataclasses.replace(cfg, **kw).validate()


def chairs_data(dev, data_dir: str) -> None:
    """Phase 11c: the stand-in corpus through cli.gen_synthetic, the train
    split on the card, and the same draws gathered on the card and read from
    the host items."""
    t = time.perf_counter()
    cli_gen_synthetic.main(["chairs", "--data_dir", data_dir, "--n_objects", str(CHAIRS_OBJECTS)])
    gen_s = time.perf_counter() - t
    root = os.path.join(data_dir, "rendered_chairs")
    pngs = sum(len(files) for _, _, files in os.walk(root)) - 1  # all_chair_names.mat
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(root) for f in files)
    print(f"cli.gen_synthetic chairs --n_objects {CHAIRS_OBJECTS}: {pngs} PNGs, "
          f"{size / 1e6:.1f} MB, in {gen_s:.1f} s (Pillow, on the host)")
    check(pngs == CHAIRS_OBJECTS * 62, "the stand-in corpus's PNG count")
    cfg = chairs_config(data_dir, seed=0)
    t = time.perf_counter()
    gen = registry.make_device_generator(cfg, device=dev)
    load_s = time.perf_counter() - t
    check(isinstance(gen, DeviceChairs) and gen.device.type == dev.type,
          "the registry's chairs generator")
    host = registry.make_train_dataset(cfg)
    rng = torch.Generator(device=dev)
    rng.manual_seed(step_seed(cfg.seed, DATA_SALT, 0))
    obj, start = gen.draw(rng, cfg.batch_size)
    card = gen.gather(obj, start).cpu().numpy()
    items = np.stack([np.concatenate(host[s * gen.n_objects + o])
                      for o, s in zip(obj.tolist(), start.tolist())])
    same = card.tobytes() == items.tobytes()
    print(f"DeviceChairs: the train split ({gen.n_objects} objects x 62 views, {len(gen)} "
          f"windows of {gen.seq_len}) decoded and uploaded in {load_s:.1f} s, "
          f"{gen.nbytes / 1e6:.1f} MB uint8 on the card; one B {cfg.batch_size} batch of the "
          f"same draws, card == host Chairs items bitwise: {same}")
    check(gen.n_objects == int(CHAIRS_OBJECTS * 0.85) and card.shape == (
        cfg.batch_size, gen.seq_len, 64, 64, 3), "DeviceChairs size or batch shape")
    check(same, "chairs windows differ between the card and the host items")


def chairs_train(dev, data_dir: str, work: str) -> str:
    """Phase 11d: the recipe through the train CLI; a mid-epoch resume; the
    host data path.  Returns the experiment directory."""
    xp = os.path.join(work, "chairs")
    argv = ["--xp_dir", xp, "--data_dir", data_dir, *CHAIRS_RECIPE, "--seed", "0",
            "--epochs", str(CHAIRS_EPOCHS), "--steps_per_epoch", str(CHAIRS_STEPS),
            "--log_every", "5"]
    print("train CLI: python -m spatiotemporal_variable_separation_tpu_torch.cli.main "
          + " ".join(argv))
    reset_launch_counts()
    state = cli_main.main(argv)
    launches = dict(mlp_resnet_rollout.variant_launches)
    rows = metrics_rows(xp)
    losses = [(int(r["step"]), float(r["loss"])) for r in rows if not r["samples_per_sec"]]
    epochs = [float(r["samples_per_sec"]) for r in rows if r["samples_per_sec"]]
    cfg = ExperimentConfig.from_json_file(os.path.join(xp, "params.json"))
    print(f"  chairs: steps {state.step}, precision {cfg.precision}, rollout kernel launches "
          f"while training {launches}; loss by step: "
          + ", ".join(f"{s}: {v:.4f}" for s, v in losses))
    check(state.step == CHAIRS_EPOCHS * CHAIRS_STEPS and cfg.precision == "bf16",
          "chairs: CLI steps or precision")
    check(launches == {"cluster": 0, "stream": 0}, "chairs: training launched the kernel")
    check(len(losses) >= 2 and all(np.isfinite(v) for _, v in losses), "chairs: loss rows")
    print(f"  last/first logged loss {losses[-1][1] / losses[0][1]:.4f} (must be below "
          f"{CHAIRS_LOSS_FALL:g})")
    check(losses[-1][1] < CHAIRS_LOSS_FALL * losses[0][1], "chairs: the loss did not fall")
    for e, sps in enumerate(epochs):
        print(f"  epoch {e}: {sps:.1f} samples/s = {cfg.batch_size / sps * 1e3:.3f} ms/step"
              + (" (includes the first step's warm-up)" if e == 0 else ""))
    check(len(epochs) == CHAIRS_EPOCHS, "chairs: one samples/s row an epoch")
    del state

    reset_launch_counts()
    train_resume_bitwise(dev, "chairs", lambda run: chairs_config(
        data_dir, xp_dir=os.path.join(work, f"chairs_resume_{run}"), seed=0,
        epochs=CHAIRS_RESUME_EPOCHS, steps_per_epoch=CHAIRS_RESUME_STEPS),
        CHAIRS_RESUME_EPOCHS * CHAIRS_RESUME_STEPS, CHAIRS_RESUME_STOP_AFTER)
    host_xp = os.path.join(work, "chairs_host")
    cli_main.main(["--xp_dir", host_xp, "--data_dir", data_dir, *CHAIRS_RECIPE, "--seed", "0",
                   "--epochs", "1", "--steps_per_epoch", str(CHAIRS_HOST_STEPS),
                   "--no-device_datagen", "--num_workers", "4", "--log_every", "5"])
    launches = dict(mlp_resnet_rollout.variant_launches)
    host_sps = [float(r["samples_per_sec"]) for r in metrics_rows(host_xp) if r["samples_per_sec"]]
    print(f"chairs host data path (--no-device_datagen --num_workers 4), 1 epoch x "
          f"{CHAIRS_HOST_STEPS} steps: {host_sps[0]:.1f} samples/s (device datagen, epoch 2: "
          f"{epochs[-1]:.1f}); rollout launches in the resume runs and here {launches}")
    check(len(host_sps) == 1 and host_sps[0] > 0, "chairs host-path samples/s")
    check(launches == {"cluster": 0, "stream": 0}, "chairs: resume or host path launched")
    return xp


def chairs_eval_cli(dev, xp: str, data_dir: str) -> None:
    """Phase 11e: cli.test_chairs_disentanglement on the bf16 checkpoint over
    the whole test split; its resume, bitwise."""
    argv = ["--xp_dir", xp, "--data_dir", data_dir, "--nt_pred", "10"]
    print(f"eval CLI (bf16 checkpoint of 11d): python -m {cli_test_chairs.__name__} "
          + " ".join(argv))
    reset_launch_counts()
    t = time.perf_counter()
    means = cli_test_chairs.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(mlp_resnet_rollout.variant_launches)
    record = json.load(open(os.path.join(xp, "evals.json")))["chairs_swap_t10"]
    with np.load(os.path.join(xp, "results_swap.npz")) as z:
        n_rows = len(z["mse"])
    print(f"  chairs_swap_t10: {n_rows} sequences in {wall:.1f} s ({n_rows / wall:.1f} "
          f"sequences/s, test-split load included); means {means}; rollout launches "
          f"{launches}; evals.json {record}")
    check(n_rows == CHAIRS_TEST_SEQS, "chairs_swap: the whole test split")
    check(all(np.isfinite(v) for v in means.values()) and 0 < means["ssim"] <= 1,
          "chairs_swap: means")
    check(launches == {"cluster": 0, "stream": 0}, "chairs_swap: the bf16 CLI launched a kernel")
    check(record["mse"] == means["mse"] and "max_batches" not in record,
          "chairs_swap: evals.json record")
    eval_resume(xp, data_dir, eval_chairs.evaluate, "chairs_swap_t10", "results_swap.npz",
                nt_pred=10, max_batches=RESUME_BATCHES, device=dev)


def chairs_eval_f32(ctx, data_dir: str, work: str) -> dict:
    """Phase 11f: the f32 seed-0 chairs model through evaluate(model_bundle=...)
    over the whole test split (one cluster launch a batch); the Evaluator on
    the card against the CPU; both kernels at the protocol's rollout shape
    (B 16 x 15 steps), timed in turns with the plain and addmm loops."""
    dev = ctx.dev
    cfg = chairs_config(data_dir, precision="f32", seed=0)
    model = build_separable_network(cfg, dev, torch.Generator().manual_seed(0)).eval()
    xp = os.path.join(work, "chairs_f32")
    os.makedirs(xp)
    n_batches = -(-CHAIRS_TEST_SEQS // CHAIRS_EVAL_B)
    reset_launch_counts()
    t = time.perf_counter()
    means = eval_chairs.evaluate(xp, data_dir, cfg.nt_pred, CHAIRS_EVAL_B,
                                 model_bundle=(model, cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(mlp_resnet_rollout.variant_launches)
    plan = card_plan(CHAIRS_EVAL_B, cfg.code_size_t, cfg.res_hidden_size, cfg.n_blocks)
    print(f"evaluate(model_bundle=f32 seed-0 chairs model, full width), {CHAIRS_TEST_SEQS} "
          f"sequences in {n_batches} batches of {CHAIRS_EVAL_B}: {wall:.1f} s "
          f"({CHAIRS_TEST_SEQS / wall:.1f} sequences/s); means {means}; rollout plan {plan} "
          f"({plan.grid // plan.cluster} clusters); launches {launches} (one a batch)")
    check(all(np.isfinite(v) for v in means.values()), "f32 chairs means")
    check((plan.variant, plan.cluster, plan.grid // plan.cluster) == ("cluster", 8, 2),
          f"the chairs B16 plan {plan} is not the cluster kernel at C 8 with 2 clusters")
    check(launches == {"cluster": n_batches, "stream": 0}, "one cluster launch a chairs batch")

    cache = {}
    test_set = Chairs(False, data_dir, cfg.nt_cond, seq_len=15, cache_frames=cache)
    swap_set = eval_chairs.SwapDataset(False, data_dir, cfg.nt_cond, np.random.RandomState(1),
                                       seq_len=15, cache_frames=cache)
    card_ev, cpu_ev = Evaluator(model), Evaluator(copy.deepcopy(model).cpu())
    card, cpu = [], []
    for b in range(CHAIRS_CPU_BATCHES):
        sw = eval_batch(swap_set, b)
        args = (np.stack([it[0] for it in sw]),
                np.stack([test_set[i][0] for i in range(b * 16, b * 16 + 16)]),
                np.stack([it[3] for it in sw]))
        card.append(card_ev.score_swap(*args, nt_skip=cfg.nt_cond)[0])
        cpu.append(cpu_ev.score_swap(*args, nt_skip=cfg.nt_cond)[0])
    card = {k: np.concatenate([m[k] for m in card]) for k in card[0]}
    cpu = {k: np.concatenate([m[k] for m in cpu]) for k in cpu[0]}
    errs = {"mse": float(np.max(np.abs(card["mse"] - cpu["mse"]) / cpu["mse"])),
            "psnr": float(np.abs(card["psnr"] - cpu["psnr"]).max()),
            "ssim": float(np.abs(card["ssim"] - cpu["ssim"]).max())}
    tols = {"mse": EVAL_MSE_RTOL, "psnr": EVAL_PSNR_ATOL, "ssim": EVAL_SSIM_ATOL}
    for k in errs:
        print(f"  Evaluator.score_swap card against CPU, {k}: worst per-sequence difference "
              f"{errs[k]:.3e} over {len(cpu[k])} sequences (tolerance {tols[k]:g})")
        check(errs[k] <= tols[k], f"the chairs Evaluator {k}, card against CPU")

    with torch.inference_mode():
        cond = np.stack([test_set[i][0] for i in range(CHAIRS_EVAL_B)])
        t0 = model.encode_t(torch.from_numpy(cond).to(dev)).contiguous()
    print("  both kernels at the chairs eval's rollout (t0 from the test split):")
    turns = rollout_turns(ctx, t0, model.t_resnet.flat_params(), cfg.nt_cond + cfg.nt_pred, {
        "cluster": plan, "stream": card_plan(CHAIRS_EVAL_B, cfg.code_size_t, cfg.res_hidden_size,
                                             cfg.n_blocks, variant="stream")})
    return {"launches": launches, "turns": turns}


def chairs_phase(ctx) -> dict:
    """Phase 11 (b-f; 11a runs with phase 3's cases): 3D Chairs on the card,
    in a working directory of its own.  Returns 11f's launches and kernel
    figures."""
    import PIL

    print(f"phase 11: Pillow {PIL.__version__}")
    with tempfile.TemporaryDirectory(dir=ctx.work) as work:
        data_dir = os.path.join(work, "chairs_data")
        modules_card_vs_cpu(ctx.dev, CHAIRS_RECIPE, "chairs", CHAIRS_EVAL_B, 11, 12,   # 11b
                            uniform=True)
        chairs_data(ctx.dev, data_dir)
        xp = chairs_train(ctx.dev, data_dir, work)
        chairs_eval_cli(ctx.dev, xp, data_dir)
        return chairs_eval_f32(ctx, data_dir, work)


# -- phases 12 and 13: TaxiBJ and SST ----------------------------------------------
# The recipes of tests/test_recipes.py:22-29, full width.
TAXIBJ_RECIPE = ("--data taxibj --nt_cond 4 --nt_pred 4 --lr 4e-5 --batch_size 100 --scheduler "
                 "--scheduler_decay 0.2 --scheduler_milestones 250 300 350 400 450 --offset 4 "
                 "--gain_resnet 0.71 --architecture vgg --lamb_ae 45 --lamb_s 0.0001").split()
SST_RECIPE = ("--data sst --nt_cond 4 --nt_pred 6 --code_size_t 64 --code_size_s 196 --offset 0 "
              "--gain_resnet 0.71 --architecture encoderSST --decoder_architecture decoderSST "
              "--lamb_ae 1 --lamb_s 100 --lamb_t 5e-6 --skipco --n_blocks 2").split()
TAXIBJ_DAYS = 120           # gen_synthetic's default days a year: 4 x 5,760 frames
SST_ZONES, SST_DAYS = list(range(1, 30)), 1600   # gen_synthetic's defaults (~1.5 GB f64)
SST_TEST_ZONES = list(range(17, 21))
SST_WIDE_ZONE = 256         # the full-basin stretch grid, one forward
# 12c/13c's CLI runs (cut from 2 x 20 for phase 16's time, see PERF.md
# section 4).
CORPUS_EPOCHS, CORPUS_STEPS = 2, 10
CORPUS_RESUME_STEPS, CORPUS_RESUME_STOP_AFTER = 6, 8   # 2 epochs x 6 steps, stopped after 8
# The last logged loss (step 20) against the first (step 5), a fresh batch
# every step: it must fall.
CORPUS_LOSS_FALL = 1.0
TAXIBJ_EVAL_B, SST_EVAL_B = 128, 64   # the eval CLIs' default batches
TAXIBJ_TEST_SEQS = 48 * 7 * 4        # the reference's test split (taxibj.py:253-254)
SST_TEST_SEQS = 4 * 305              # zones 17-20, 320 test days each, windows of 4 + 10 + 1
CORPUS_CPU_B, CORPUS_CPU_BATCHES = 16, 2
# SST's SSIM, card against CPU, per sequence.  The protocol renormalizes the
# physical fields (~295 K) by the normalized data's min/max (~6 wide), so
# SSIM sees values ~50 with a local variance ~1e-3, and an f32 E[x^2] - mu^2
# carries ~3e-4 of rounding, the size of c2: computed in f32, the card and
# the CPU gave per-sequence SSIMs 0.838 apart on an H100.  eval/sst.py
# computes it in f64, so what remains is the forecasts' own f32 difference
# (~2e-7 relative) through the metric's conditioning: 3.8e-10 measured.
SST_SSIM_ATOL = 1e-6


def corpus_config(recipe: list, **kw) -> ExperimentConfig:
    cfg = config_from_args(build_parser().parse_args(recipe + ["--xp_dir", "", "--data_dir", ""]))
    return dataclasses.replace(cfg, **kw).validate()


def modules_card_vs_cpu(dev, recipe: list, label: str, batch: int, x_seed: int, seq_seed: int,
                        uniform: bool = False) -> None:
    """Phases 11b, 12a and 13a: the seed-0 model's encoder, decoder and (for SST)
    integrator, card against CPU, f32 (TF32 off) and bf16, eval and train
    mode, each on the CPU encoder's outputs so that each module is held
    alone; then one f32 train step at B 8, card against CPU.  Inputs are
    standard normal (the normalized fields of TaxiBJ and SST), or uniform in
    [0, 1) (images)."""
    def draw(seed: int, shape: tuple) -> np.ndarray:
        rng = np.random.default_rng(seed)
        if uniform:
            return rng.random(shape, dtype=np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    cfg = corpus_config(recipe)
    x = draw(x_seed, (batch, cfg.nt_cond) + cfg.frame_shape)
    f32_ref = {}
    for precision in ("f32", "bf16"):
        cfg = corpus_config(recipe, precision=precision)
        model = build_separable_network(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
        for train in (False, True):
            cpu, card = copy.deepcopy(model).train(train), copy.deepcopy(model).to(dev).train(train)
            xs = torch.from_numpy(x)
            with torch.no_grad():
                s_full = cpu.encode_s(xs)
                s, skips = s_full if cfg.skipco else (s_full, None)
                t = cpu.encode_t(xs)
                pairs = {
                    type(cpu.Es).__name__: (cpu.Es(xs), card.Es(xs.to(dev))),
                    type(cpu.decoder).__name__: (
                        cpu.decoder(s, t, skip=skips),
                        card.decoder(s.to(dev), t.to(dev), skip=None if skips is None else
                                     [k.to(dev) for k in skips])),
                }
                if not isinstance(cpu.t_resnet, MLPResnet):
                    t_int = t.to(cpu.t_resnet.dtype)
                    pairs[type(cpu.t_resnet).__name__] = (cpu.t_resnet(t_int)[0],
                                                          card.t_resnet(t_int.to(dev))[0])
            mode = "train" if train else "eval"
            for name, (ref, out) in pairs.items():
                ref, out = ref.float(), out.float().cpu()
                scale = float(ref.abs().max())
                rel = float((out - ref).abs().max()) / scale
                if precision == "f32":
                    f32_ref[name, train] = ref
                    tol, extra = ENC_F32_TOL, ""
                else:
                    tol = ENC_BF16_TOL[train]
                    extra = (f"; card and CPU bf16 against CPU f32: "
                             f"{float((out - f32_ref[name, train]).abs().max()) / scale:.3e} and "
                             f"{float((ref - f32_ref[name, train]).abs().max()) / scale:.3e}")
                print(f"{name} ({label} seed-0 model, B {x.shape[0]}), card against CPU, "
                      f"{precision}, {mode} mode: max |card - CPU| {rel:.3e} of the output's max "
                      f"{scale:.4g} (tolerance {tol:g}){extra}")
                check(bool(torch.isfinite(out).all()) and rel <= tol,
                      f"{label} {name} {precision} {mode}, card against CPU")
    cfg = corpus_config(recipe, precision="f32", batch_size=TRAIN_CHECK_B)
    seq = draw(seq_seed, (TRAIN_CHECK_B, cfg.nt_cond + cfg.nt_pred) + cfg.frame_shape)
    train_step_card_vs_cpu(dev, cfg, seq, f"the {label} recipe")


def corpus_sampler(dev, label: str, cfg, host, gen, make_s: float, build_s: float,
                   upload_s: float) -> None:
    """Phases 12b and 13b: one batch of the same draws gathered on the card
    and read from the host items, bitwise."""
    rng = torch.Generator(device=dev)
    rng.manual_seed(step_seed(cfg.seed, DATA_SALT, 0))
    draws = gen.draw(rng, cfg.batch_size)
    card = gen.gather(*(draws if isinstance(draws, tuple) else (draws,))).cpu().numpy()
    if isinstance(draws, tuple):  # (zone, k): the host index is zone * len_ + k
        idx = (draws[0] * host.len_ + draws[1]).tolist()
    else:
        idx = draws.tolist()
    items = np.stack([np.concatenate(host[i][:2]) for i in idx])
    same = card.tobytes() == items.tobytes()
    print(f"{type(gen).__name__} ({label}): stand-in made in memory in {make_s:.1f} s, the "
          f"train split built in {build_s:.1f} s, uploaded in {upload_s:.1f} s: {len(gen)} "
          f"windows of {gen.seq_len}, {gen.nbytes / 1e6:.1f} MB on the card; one B "
          f"{cfg.batch_size} batch of the same draws, card == host items bitwise: {same}")
    check(card.shape == (cfg.batch_size, gen.seq_len) + cfg.frame_shape,
          f"{label}: batch shape {card.shape}")
    check(same, f"{label} windows differ between the card and the host items")


def corpus_train(dev, label: str, recipe: list, gen, work: str, trace: bool = False) -> str:
    """Phases 12c and 13c: the recipe through ``run_training`` with the
    sampler over the stand-in held in memory (phase 18e runs the train CLI
    over the stand-in's HDF5 files), 2 epochs x 10 steps: the loss falls, 0
    launches, samples/s; with ``trace``, a profiler trace of one fused step
    (PERF.md cites TaxiBJ's idle share); then a mid-epoch resume, bitwise.
    Returns the experiment directory."""
    xp = os.path.join(work, label)
    cfg = corpus_config(recipe, xp_dir=xp, seed=0, epochs=CORPUS_EPOCHS,
                        steps_per_epoch=CORPUS_STEPS)
    os.makedirs(xp)
    cfg.save(os.path.join(xp, "params.json"))
    print(f"{label} training: run_training(device_gen={type(gen).__name__}) at the recipe "
          f"{' '.join(recipe)}, bf16, {CORPUS_EPOCHS} epochs x {CORPUS_STEPS} steps")
    reset_launch_counts()
    state = run_training(cfg, device=dev, log_every=5, log_fn=lambda s: None, device_gen=gen)
    launches = dict(mlp_resnet_rollout.variant_launches)
    rows = metrics_rows(xp)
    losses = [(int(r["step"]), float(r["loss"])) for r in rows if not r["samples_per_sec"]]
    epochs = [float(r["samples_per_sec"]) for r in rows if r["samples_per_sec"]]
    print(f"  {label}: steps {state.step}, precision {cfg.precision}, rollout kernel launches "
          f"while training {launches}; loss by step: "
          + ", ".join(f"{s}: {v:.4f}" for s, v in losses))
    check(state.step == CORPUS_EPOCHS * CORPUS_STEPS and cfg.precision == "bf16",
          f"{label}: steps or precision")
    check(launches == {"cluster": 0, "stream": 0}, f"{label}: training launched the kernel")
    check(len(losses) >= 2 and all(np.isfinite(v) for _, v in losses), f"{label}: loss rows")
    print(f"  last/first logged loss {losses[-1][1] / losses[0][1]:.4f} (must be below "
          f"{CORPUS_LOSS_FALL:g})")
    check(losses[-1][1] < CORPUS_LOSS_FALL * losses[0][1], f"{label}: the loss did not fall")
    for e, sps in enumerate(epochs):
        print(f"  epoch {e}: {sps:.1f} samples/s = {cfg.batch_size / sps * 1e3:.3f} ms/step"
              + (" (includes the first step's warm-up)" if e == 0 else ""))
    check(len(epochs) == CORPUS_EPOCHS, f"{label}: one samples/s row an epoch")
    if trace:
        step = make_fused_datagen_step(state.model, cfg, state.optimizer, gen)
        prof = device_profile(lambda: step(state), 1)
        print(f"  the fused step, one traced: {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms, idle {prof['idle']:.1%}; {prof['kernels']:.0f} device "
              f"kernels")
    del state
    reset_launch_counts()
    train_resume_bitwise(dev, label, lambda run: corpus_config(
        recipe, xp_dir=os.path.join(work, f"{label}_resume_{run}"), seed=0,
        epochs=CORPUS_EPOCHS, steps_per_epoch=CORPUS_RESUME_STEPS),
        CORPUS_EPOCHS * CORPUS_RESUME_STEPS, CORPUS_RESUME_STOP_AFTER, device_gen=gen)
    check(mlp_resnet_rollout.variant_launches == {"cluster": 0, "stream": 0},
          f"{label}: the resume runs launched the kernel")
    return xp


def corpus_eval_checkpoint(dev, xp: str, label: str, evaluate, test_set, n_seq: int,
                           protocol: str, **extra) -> dict:
    """Phases 12d and 13d: the protocol on the bf16 checkpoint over the whole
    test split, as its CLI scores it (the checkpoint loaded from ``xp``), with
    the test split held in memory; the CLI's ``evals.json`` record."""
    reset_launch_counts()
    t = time.perf_counter()
    means = evaluate(xp, "", test_set=test_set, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(mlp_resnet_rollout.variant_launches)
    eval_common.write_eval_json(xp, protocol, means, epoch=None, bn_reestimate=0, **extra)
    record = json.load(open(os.path.join(xp, "evals.json")))[protocol]
    print(f"{label} protocol on the bf16 checkpoint: {n_seq} sequences in {wall:.1f} s "
          f"({n_seq / wall:.1f} sequences/s, checkpoint load included); means {means}; rollout "
          f"launches {launches}; evals.json {record}")
    check(all(np.isfinite(v) for v in means.values()), f"{label}: non-finite means")
    check(launches == {"cluster": 0, "stream": 0}, f"{label}: the bf16 eval launched a kernel")
    check(all(record[k] == v for k, v in means.items()) and "max_batches" not in record,
          f"{label}: evals.json record")
    return {"wall_s": wall, "means": means}


def taxibj_phase(ctx, work: str) -> dict:
    """Phase 12: TaxiBJ on the card.  Returns 12e's launches and kernel
    figures, the experiment and the splits."""
    t_phase, dev = time.perf_counter(), ctx.dev
    modules_card_vs_cpu(dev, TAXIBJ_RECIPE, "TaxiBJ", CORPUS_CPU_B, 12, 13)   # 12a
    t = time.perf_counter()
    years = [(data, dates) for _, data, dates in synthetic_corpora.taxibj_years(TAXIBJ_DAYS)]
    make_s = time.perf_counter() - t
    cfg = corpus_config(TAXIBJ_RECIPE, seed=0)
    t = time.perf_counter()
    train, test = TaxiBJ.from_arrays(years, len_closeness=cfg.nt_cond + cfg.nt_pred,
                                     nt_cond=cfg.nt_cond)
    build_s = time.perf_counter() - t
    del years
    t = time.perf_counter()
    gen = DeviceItems.from_host_dataset(train, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    check(len(test) == TAXIBJ_TEST_SEQS, "the TaxiBJ test split's size")
    corpus_sampler(dev, "TaxiBJ", cfg, train, gen, make_s, build_s, upload_s)   # 12b
    xp = corpus_train(dev, "taxibj", TAXIBJ_RECIPE, gen, work, trace=True)     # 12c
    del gen
    corpus_eval_checkpoint(dev, xp, "TaxiBJ mse_t4", eval_taxibj.evaluate, test,  # 12d
                           TAXIBJ_TEST_SEQS, "taxibj")
    # 12e: the f32 seed-0 model through evaluate(model_bundle=...)
    cfg = corpus_config(TAXIBJ_RECIPE, precision="f32", seed=0)
    model = build_separable_network(cfg, dev, torch.Generator().manual_seed(0)).eval()
    n_batches = -(-TAXIBJ_TEST_SEQS // TAXIBJ_EVAL_B)
    reset_launch_counts()
    t = time.perf_counter()
    means = eval_taxibj.evaluate(os.path.join(work, "taxibj_f32"), "", model_bundle=(model, cfg),
                                 test_set=test)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(mlp_resnet_rollout.variant_launches)
    plan = card_plan(TAXIBJ_EVAL_B, cfg.code_size_t, cfg.res_hidden_size, cfg.n_blocks)
    print(f"evaluate(model_bundle=f32 seed-0 TaxiBJ model, full width), {TAXIBJ_TEST_SEQS} "
          f"sequences in {n_batches} batches of {TAXIBJ_EVAL_B}: {wall:.2f} s; means {means}; "
          f"rollout plan {plan} ({plan.grid // plan.cluster} clusters); launches {launches}")
    check(np.isfinite(means["mse_t4"]), "f32 TaxiBJ mse_t4")
    check((plan.variant, plan.cluster, plan.grid // plan.cluster) == ("cluster", 8, 16),
          f"the TaxiBJ B128 plan {plan} is not the cluster kernel at C 8 with 16 clusters")
    check(launches == {"cluster": n_batches, "stream": 0}, "one cluster launch a TaxiBJ batch")
    cut = CORPUS_CPU_B * CORPUS_CPU_BATCHES
    sub = TaxiBJ(test.data[:cut], test.nt_cond, test.mmn)
    card = eval_taxibj.frame_mses("", model, cfg, sub, CORPUS_CPU_B)
    cpu = eval_taxibj.frame_mses("", copy.deepcopy(model).cpu(), cfg, sub, CORPUS_CPU_B)
    err = float(np.max(np.abs(card - cpu) / cpu))
    print(f"  per-sequence frame MSEs, card against CPU, {cut} sequences: worst relative "
          f"{err:.3e} (tolerance {EVAL_MSE_RTOL:g})")
    check(err <= EVAL_MSE_RTOL, "TaxiBJ frame MSEs, card against CPU")
    with torch.inference_mode():
        cond = torch.from_numpy(test.data[:TAXIBJ_EVAL_B, :cfg.nt_cond].copy()).to(dev)
        t0 = model.encode_t(cond).contiguous()
    turns = rollout_turns(ctx, t0, model.t_resnet.flat_params(), cfg.nt_cond + 4, {
        "cluster": plan, "stream": card_plan(TAXIBJ_EVAL_B, cfg.code_size_t, cfg.res_hidden_size,
                                             cfg.n_blocks, variant="stream")})
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "turns": turns, "xp": xp, "splits": (train, test)}


def sst_phase(dev, work: str) -> dict:
    """Phase 13: SST on the card.  Returns the launches of 13e."""
    t_phase = time.perf_counter()
    modules_card_vs_cpu(dev, SST_RECIPE, "SST", CORPUS_CPU_B // 2, 13, 13)   # 13a
    wide = corpus_config(SST_RECIPE, precision="bf16", zone_size=SST_WIDE_ZONE)
    model = build_separable_network(wide, dev, torch.Generator().manual_seed(0)).eval()
    z = SST_WIDE_ZONE
    with torch.inference_mode():
        fc, t_codes, _, _ = model.get_forecast(torch.randn(2, 4, z, z, 1, device=dev), 10)
    print(f"SST at --zone_size {z} (bf16, seed 0): forecast {tuple(fc.shape)}, T codes "
          f"{tuple(t_codes.shape)}")
    check(tuple(fc.shape) == (2, 10, z, z, 1)
          and tuple(t_codes.shape) == (2, 10, wide.code_size_t, z // 4, z // 4)
          and bool(torch.isfinite(fc.float()).all()), f"the SST forward at zone_size {z}")
    del model, fc, t_codes
    cfg = corpus_config(SST_RECIPE, seed=0)
    t = time.perf_counter()
    arrays = synthetic_corpora.sst_zone_arrays(zones=SST_ZONES, n_days=SST_DAYS,
                                               size=cfg.zone_size)
    make_s = time.perf_counter() - t
    t = time.perf_counter()
    train = SST(None, cfg.nt_cond, cfg.nt_pred, True, zones=SST_ZONES, arrays=arrays)
    build_s = time.perf_counter() - t
    test = SST(None, cfg.nt_cond, eval_sst.NT_PRED, False, zones=SST_TEST_ZONES, eval=True,
               arrays=arrays)
    del arrays
    t = time.perf_counter()
    gen = DeviceZoneWindows.from_host_dataset(train, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    check(len(test) == SST_TEST_SEQS, "the SST test split's size")
    corpus_sampler(dev, "SST", cfg, train, gen, make_s, build_s, upload_s)   # 13b
    xp = corpus_train(dev, "sst", SST_RECIPE, gen, work)                     # 13c
    del gen
    ckpt = corpus_eval_checkpoint(dev, xp, "SST", eval_sst.evaluate, test, SST_TEST_SEQS, "sst",
                                  zones=SST_TEST_ZONES, reference_broadcast=False)   # 13d
    means = ckpt["means"]
    check(0 < means["ssim_t6"] <= 1 and 0 < means["ssim_t10"] <= 1, "SST SSIM outside (0, 1]")
    # 13e: the f32 seed-0 model: ConvResnet loops, no kernel
    cfg = corpus_config(SST_RECIPE, precision="f32", seed=0)
    model = build_separable_network(cfg, dev, torch.Generator().manual_seed(0)).eval()
    reset_launch_counts()
    t = time.perf_counter()
    means = eval_sst.evaluate(os.path.join(work, "sst_f32"), "", model_bundle=(model, cfg),
                              test_set=test)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(mlp_resnet_rollout.variant_launches)
    print(f"evaluate(model_bundle=f32 seed-0 SST model, full width), {SST_TEST_SEQS} sequences "
          f"in batches of {SST_EVAL_B}: {wall:.2f} s; means {means}; rollout launches "
          f"{launches} (ConvResnet loops its module)")
    check(all(np.isfinite(v) for v in means.values()), "f32 SST means")
    check(launches == {"cluster": 0, "stream": 0}, "the f32 SST eval launched a rollout kernel")
    cpu_model = copy.deepcopy(model).cpu()
    for broadcast, batches in ((False, CORPUS_CPU_BATCHES), (True, 1)):
        card = eval_sst.sequence_scores("", model, cfg, test, CORPUS_CPU_B, batches, broadcast)
        cpu = eval_sst.sequence_scores("", cpu_model, cfg, test, CORPUS_CPU_B, batches, broadcast)
        mse_err = float(np.max(np.abs(card[0] - cpu[0]) / cpu[0]))
        ssim_err = float(np.max(np.abs(card[1] - cpu[1])))
        print(f"  per-sequence scores, card against CPU, {len(cpu[0])} sequences"
              f"{', reference_broadcast' if broadcast else ''}: MSE worst relative "
              f"{mse_err:.3e} (tolerance {EVAL_MSE_RTOL:g}), SSIM worst {ssim_err:.3e} "
              f"(tolerance {SST_SSIM_ATOL:g})")
        check(mse_err <= EVAL_MSE_RTOL and ssim_err <= SST_SSIM_ATOL,
              "SST scores, card against CPU")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "xp": xp, "splits": (train, test)}


def taxibj_and_sst(ctx) -> dict:
    """Phases 12 and 13, the product ``ctx.corpora`` that phase 18 reads: their
    experiments and splits, in a directory that outlives them."""
    work = os.path.join(ctx.work, "corpora")
    os.makedirs(work)
    return {"taxibj": taxibj_phase(ctx, work), "sst": sst_phase(ctx.dev, work)}


# -- phase 18: TaxiBJ and SST from their HDF5 files ------------------------------
# 18e's train CLI from the files: 1 epoch of a few steps at the recipe.
HDF5_TRAIN_STEPS = 5


def corpus_mb(d: str, prefix: str) -> float:
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)
               if n.startswith(prefix)) / 1e6


def same_taxibj(ours: TaxiBJ, ref: TaxiBJ) -> bool:
    return (ours.data.shape == ref.data.shape and ours.data.tobytes() == ref.data.tobytes()
            and (ours.mmn._min, ours.mmn._max) == (ref.mmn._min, ref.mmn._max))


def same_sst(ours: SST, ref: SST) -> bool:
    return ((ours.zone_size, ours.len_, ours.first, len(ours))
            == (ref.zone_size, ref.len_, ref.first, len(ref))
            and all(ours.data[z].tobytes() == ref.data[z].tobytes()
                    and all(a.tobytes() == b.tobytes() for a, b in
                            zip(ours.cst[z] + ours.climato[z], ref.cst[z] + ref.climato[z]))
                    for z in ref.zones))


def hdf5_files(taxibj_dir: str, sst_dir: str) -> dict:
    """18a: both stand-ins written through ``gen_synthetic`` (the port's
    HDF5 writer), the writer and reader timed alone on one file each.
    Returns the seconds."""
    seconds = {}
    for corpus, d, argv in (
            ("taxibj", taxibj_dir, ["--days_per_year", str(TAXIBJ_DAYS)]),
            ("sst", sst_dir, ["--n_days", str(SST_DAYS), "--size",
                              str(corpus_config(SST_RECIPE).zone_size), "--zones"]
             + [str(z) for z in SST_ZONES])):
        t = time.perf_counter()
        cli_gen_synthetic.main([corpus, "--data_dir", d] + argv)
        seconds[f"gen_{corpus}"] = time.perf_counter() - t
        mb = corpus_mb(d, "BJ" if corpus == "taxibj" else "data_")
        print(f"  gen_synthetic {corpus}: {len(os.listdir(d))} files, {mb:.1f} MB in "
              f"{seconds[f'gen_{corpus}']:.2f} s, the stand-in's arrays made in that time too")
    check("h5py" not in sys.modules, "the port imported h5py")
    print(f"  h5py installed on this machine: {importlib.util.find_spec('h5py') is not None}; "
          f"imported: {'h5py' in sys.modules}")
    # the writer and the reader alone: one TaxiBJ year (94.4 MB) and one SST zone
    for label, path in (("TaxiBJ year", os.path.join(taxibj_dir, "BJ13_M32x32_T30_InOut.h5")),
                        ("SST zone", os.path.join(sst_dir, f"data_{SST_ZONES[0]}.nc"))):
        t = time.perf_counter()
        with hdf5.open(path) as f:
            arrays = {name: (f[name][()], dict(f[name].attrs)) for name in f}
        read_s = time.perf_counter() - t
        copy_path = path + ".rewritten"
        t = time.perf_counter()
        hdf5.write(copy_path, {name: arrays[name] for name in
                               (("data", "date") if label == "TaxiBJ year"
                                else ("thetao", "daily_mean", "daily_std"))})
        write_s = time.perf_counter() - t
        mb = os.path.getsize(path) / 1e6
        same = open(copy_path, "rb").read() == open(path, "rb").read()
        os.unlink(copy_path)
        print(f"  {label}, {mb:.1f} MB: read (hdf5.open, every dataset's [()], page cache warm) "
              f"{read_s * 1e3:.1f} ms = {mb / read_s:.0f} MB/s; written again (hdf5.write) "
              f"{write_s * 1e3:.1f} ms = {mb / write_s:.0f} MB/s, byte-equal: {same}")
        check(same, f"{label}: the rewritten file differs")
        seconds[f"read_{label}"], seconds[f"write_{label}"] = read_s, write_s
    return seconds


def hdf5_verify(taxibj_dir: str, sst_dir: str) -> None:
    """18b: ``verify_corpus`` over both directories (after 18c, on the
    TaxiBJ cache it built)."""
    for benchmark, d, argv in (("taxibj", taxibj_dir, []),
                               ("sst", sst_dir, ["--zones"] + [str(z) for z in SST_ZONES])):
        t = time.perf_counter()
        rc = cli_verify_corpus.main([benchmark, "--data_dir", d] + argv)
        print(f"  verify_corpus {benchmark}: exit {rc} in {time.perf_counter() - t:.1f} s")
        check(rc == 0, f"verify_corpus {benchmark}")


def hdf5_datasets(taxibj_dir: str, sst_dir: str, taxibj: dict, sst: dict) -> None:
    """18c-d: the loaders over the files against phases 12-13's splits,
    made in memory from the same stand-in arrays: bitwise."""
    cfg = corpus_config(TAXIBJ_RECIPE, seed=0)
    L = cfg.nt_cond + cfg.nt_pred
    nbytes, t = 0, time.perf_counter()
    for year in range(13, 17):  # what make_datasets reads
        with hdf5.open(os.path.join(taxibj_dir, f"BJ{year}_M32x32_T30_InOut.h5")) as f:
            nbytes += f["data"][()].nbytes + f["date"][()].nbytes
    read_s = time.perf_counter() - t
    t = time.perf_counter()
    built = TaxiBJ.make_datasets(taxibj_dir, len_closeness=L, nt_cond=cfg.nt_cond)
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    cached = TaxiBJ.make_datasets(taxibj_dir, len_closeness=L, nt_cond=cfg.nt_cond)
    cached_s = time.perf_counter() - t
    same = [same_taxibj(o, r) for splits in (built, cached)
            for o, r in zip(splits, taxibj["splits"])]
    print(f"  the 4 TaxiBJ years read alone (data and date, {nbytes / 1e6:.1f} MB) in "
          f"{read_s:.3f} s; "
          f"TaxiBJ.make_datasets over the 4 files: read, windowed and cached in "
          f"{build_s:.2f} s ({corpus_mb(taxibj_dir, 'closeness_'):.1f} MB cache), read back "
          f"from the cache in {cached_s * 1e3:.1f} ms (memory-mapped: "
          f"{isinstance(cached[0].data, np.memmap)}); train and test windows and min/max "
          f"bitwise phase 12's from_arrays: {same}")
    check(all(same), "TaxiBJ from the files differs from the in-memory splits")
    sst_cfg = corpus_config(SST_RECIPE, seed=0)
    for split, (train, zones, nt_pred) in enumerate(((True, SST_ZONES, sst_cfg.nt_pred),
                                                     (False, SST_TEST_ZONES, eval_sst.NT_PRED))):
        t = time.perf_counter()
        files = SST(sst_dir, sst_cfg.nt_cond, nt_pred, train, zones=zones, eval=not train)
        secs = time.perf_counter() - t
        same = same_sst(files, sst["splits"][split])
        print(f"  SST({'train' if train else 'eval'}, zones {zones[0]}-{zones[-1]}) over "
              f"{len(zones)} files: {secs:.2f} s, {len(files)} windows, bitwise phase 13's "
              f"SST(arrays=...): {same}")
        check(same, "SST from the files differs from the in-memory split")


def hdf5_train_cli(taxibj_dir: str, work: str) -> dict:
    """18e: the TaxiBJ recipe through the train CLI from the files."""
    xp = os.path.join(work, "taxibj_files")
    argv = (["--xp_dir", xp, "--data_dir", taxibj_dir] + TAXIBJ_RECIPE
            + ["--seed", "0", "--epochs", "1", "--steps_per_epoch", str(HDF5_TRAIN_STEPS),
               "--log_every", "1"])
    print("  train CLI: python -m spatiotemporal_variable_separation_tpu_torch.cli.main "
          + " ".join(argv))
    reset_launch_counts()
    t = time.perf_counter()
    state = cli_main.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(mlp_resnet_rollout.variant_launches)
    rows = metrics_rows(xp)
    losses = [(int(r["step"]), float(r["loss"])) for r in rows if not r["samples_per_sec"]]
    sps = [float(r["samples_per_sec"]) for r in rows if r["samples_per_sec"]]
    batch = ExperimentConfig.from_json_file(os.path.join(xp, "params.json")).batch_size
    print(f"  {state.step} steps in {wall:.1f} s (start-up, the cached windows' upload and "
          f"the first step's warm-up included); loss by step: "
          + ", ".join(f"{s}: {v:.4f}" for s, v in losses)
          + f"; the epoch's {sps[0]:.1f} samples/s = {batch / sps[0] * 1e3:.1f} ms/step "
          f"(warm-up included); rollout kernel launches {launches}")
    check(state.step == HDF5_TRAIN_STEPS and len(losses) == HDF5_TRAIN_STEPS
          and all(np.isfinite(v) for _, v in losses), "the TaxiBJ train CLI from the files")
    check(launches == {"cluster": 0, "stream": 0}, "TaxiBJ training launched the kernel")
    return {"launches": launches, "wall_s": wall, "ms_step": batch / sps[0] * 1e3,
            "losses": losses}


def hdf5_eval_clis(dev, taxibj_dir: str, sst_dir: str, work: str, taxibj: dict,
                   sst: dict) -> dict:
    """18f: ``test_taxibj`` (phase 12's experiment in f32: the cluster
    kernel) and ``test_sst`` (phase 13's) from the files, each against the
    same eval of the in-memory split, bitwise under ``cudnn.deterministic``,
    with the same launches."""
    xp = os.path.join(work, "taxibj_f32_view")
    shutil.copytree(taxibj["xp"], xp)
    params = json.load(open(os.path.join(xp, "params.json")))
    params["precision"] = "f32"  # parameters are f32 under every policy
    json.dump(params, open(os.path.join(xp, "params.json"), "w"))
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, main, xp_dir, data_dir, evaluate, test in (
                ("taxibj", cli_test_taxibj.main, xp, taxibj_dir, eval_taxibj.evaluate,
                 taxibj["splits"][1]),
                ("sst", cli_test_sst.main, sst["xp"], sst_dir, eval_sst.evaluate,
                 sst["splits"][1])):
            reset_launch_counts()
            memory = evaluate(xp_dir, "", test_set=test, device=dev)
            torch.cuda.synchronize()
            mem_launches = dict(mlp_resnet_rollout.variant_launches)
            _, secs, cli_launches = run_main(f"  test_{label} CLI", main,
                                             ["--xp_dir", xp_dir, "--data_dir", data_dir])
            files = json.load(open(os.path.join(xp_dir, "evals.json")))[label]
            same = all(files[k] == v for k, v in memory.items())
            print(f"  test_{label} CLI from the files on phase {12 if label == 'taxibj' else 13}"
                  f"'s experiment{' in f32' if label == 'taxibj' else ''}: {secs:.2f} s; "
                  f"{ {k: files[k] for k in memory} }; in memory {memory}; bitwise: {same}; "
                  f"launches from the files {cli_launches}, in memory {mem_launches}")
            check(same, f"test_{label} from the files differs from the in-memory eval")
            check(cli_launches == mem_launches, f"test_{label}: launches differ")
            out[label] = {"launches": cli_launches, "memory_launches": mem_launches,
                          "means": memory, "seconds": secs}
    finally:
        torch.backends.cudnn.deterministic = False
    n_batches = -(-TAXIBJ_TEST_SEQS // TAXIBJ_EVAL_B)
    check(out["taxibj"]["launches"] == {"cluster": n_batches, "stream": 0},
          "test_taxibj in f32: one cluster launch a batch")
    check(out["sst"]["launches"] == {"cluster": 0, "stream": 0}, "test_sst launched a kernel")
    return out


def hdf5_phase(ctx) -> dict:
    """Phase 18: TaxiBJ and SST from their HDF5 files, beside phases
    12-13's in-memory route (``ctx.corpora``).  Returns 18e-f's launches."""
    taxibj, sst = ctx.corpora["taxibj"], ctx.corpora["sst"]
    with tempfile.TemporaryDirectory(dir=ctx.work) as work:
        taxibj_dir, sst_dir = os.path.join(work, "taxibj_data"), os.path.join(work, "sst_data")
        seconds = hdf5_files(taxibj_dir, sst_dir)                       # 18a
        hdf5_datasets(taxibj_dir, sst_dir, taxibj, sst)                 # 18c-d
        hdf5_verify(taxibj_dir, sst_dir)                                # 18b
        train = hdf5_train_cli(taxibj_dir, work)                        # 18e
        evals = hdf5_eval_clis(ctx.dev, taxibj_dir, sst_dir, work, taxibj, sst)   # 18f
    return {"train": train, "evals": evals, "seconds": seconds}


# -- phase 14: --no_s, the stability probe and the operations tooling ------------

NO_S_STEPS = 6              # the --no_s wave recipe, f32, 1 epoch on the card
# gen_wave's corpus for 14a and verify_corpus wave: 10 sequences (8 train, 2
# test) of 90 frames, 45 after the downsample by 2 (the eval's nt_cond + 40).
OPS_WAVE_SEQS, OPS_WAVE_SEQ_LEN = 10, 90
NO_S_EVAL_B = 128
NO_S_T_COMFORT = 1e3        # 14a's frame tolerances, see no_s_wave
NO_S_DEC_TOL = 1e-3
PROBE_B, PROBE_STEPS = 32, 20           # the diagnose CLI's defaults
# Gains, norms and S statistics of a probe, card against CPU (f32, TF32
# off): the same f32 encoders and rollout summed in another order, ~1e-6.
PROBE_RTOL = 1e-4
MONITOR_B, MONITOR_EPOCHS, MONITOR_STEPS = 32, 2, 3
SUPERVISED_EPOCHS, SUPERVISED_STEPS = 2, 10   # cut from 2 x 20 (PERF.md section 4)
# 14d's stop: the supervisor's deadline is an hour away on its clock, and the
# clock jumps past it once the child prints this step's loss line, so the
# SIGTERM lands at that step or just after it, however fast the host starts.
SUPERVISED_STOP_STEP = 5
SUPERVISED_DEADLINE_MIN = 60.0
SUPERVISED_CLOCK_JUMP_S = 10_000.0
OPS_CHAIRS_OBJECTS = 5      # 4 train and 1 test object for verify_corpus chairs
#: sha256 of ``gen_synthetic mnist --seed 0`` (``MNIST/raw/<file>``); the CPU
#: test ``tests/test_torch_ops_tools.py`` pins the same.
MNIST_STANDIN_SHA256 = {
    "t10k-images-idx3-ubyte": "cb3385a9b99f9b3b13c948b0554a02d0eef407b209d998ccf910ded4c3468938",
    "t10k-labels-idx1-ubyte": "957a673c0182b877a1b3a65c73ac4bf4e7dc94b49f1621c2da5ee997be1728ce",
    "train-images-idx3-ubyte": "f5b66961e04f1062bf50ce4d6353db409c38aa9e4bdb2bb144443d8ac351a1dd",
    "train-labels-idx1-ubyte": "6300936e6f8242fe267f7cbc323bd574be8f9184c5effdd4dbf00c8fe62146ff",
}
# The train CLI for 14d's children, with the cuDNN and TF32 settings of this
# script, so that a run stopped and resumed can be held bitwise to one that
# was not.
# It prints the rollout kernel's launches at its end, stopped or not, for the
# kernels line.
DETERMINISTIC_ENTRY = """import json
import sys

import torch

torch.backends.cudnn.deterministic = True
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from spatiotemporal_variable_separation_tpu_torch.cli import main
from spatiotemporal_variable_separation_tpu_torch.ops.rollout import mlp_resnet_rollout

mlp_resnet_rollout.variant_launches = dict.fromkeys(mlp_resnet_rollout.variant_launches, 0)
try:
    main.main(sys.argv[1:])
finally:
    print("rollout launches: " + json.dumps(mlp_resnet_rollout.variant_launches), flush=True)
"""


def as_f64(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` computing, and holding its parameters, in f64 (its modules'
    ``dtype``/``out_dtype`` too)."""
    model.double()
    for m in model.modules():
        for attr in ("dtype", "out_dtype"):
            if hasattr(m, attr):
                setattr(m, attr, torch.float64)
    return model


def write_small_wave(ctx) -> str:
    """The product ``ctx.small_wave``: a small ``gen_wave`` corpus made on the
    card, which 14a trains on and verifies and 15f scores.  Returns its
    directory."""
    data_dir = os.path.join(ctx.work, "wave_small")
    wave_eq.generate_dataset(data_dir, OPS_WAVE_SEQS, OPS_WAVE_SEQ_LEN, seed=WAVE_SEED,
                             device=ctx.dev)
    return data_dir


def no_s_wave(dev, work: str, data_dir: str) -> dict:
    """Phase 14a: the wave recipe with ``--no_s`` at full width, f32, trained
    a few steps through the train CLI on the corpus in ``data_dir``, then its
    eval forecast through the streaming kernel against the CPU.  Returns the
    xp dir and the forecast's launches."""
    xp = os.path.join(work, "xps", "wave_no_s")
    argv = ["--xp_dir", xp, "--data_dir", data_dir, *WAVE_RECIPES["wave"], "--no_s",
            "--precision", "f32", "--seed", "0", "--epochs", "1", "--steps_per_epoch",
            str(NO_S_STEPS), "--chkpt_interval", "1", "--log_every", "1"]
    print("train CLI: python -m spatiotemporal_variable_separation_tpu_torch.cli.main "
          + " ".join(argv))
    reset_launch_counts()
    state = cli_main.main(argv)
    train_launches = dict(mlp_resnet_rollout.variant_launches)
    rows = [r for r in metrics_rows(xp) if not r["samples_per_sec"]]
    s_inv = sorted({float(r["s_inv"]) for r in rows})
    cfg = ExperimentConfig.from_json_file(os.path.join(xp, "params.json"))
    print(f"  --no_s: S module {type(state.model.Es).__name__}, codes S {cfg.code_size_s} / T "
          f"{cfg.code_size_t}, mixing {cfg.mixing}, steps {state.step}, s_inv logged {s_inv}, "
          f"loss {[float(r['loss']) for r in rows]}, launches while training {train_launches}")
    check(type(state.model.Es).__name__ == "ConstantS" and state.step == NO_S_STEPS
          and cfg.no_s and cfg.mixing == "mul", "the --no_s run")
    check(len(rows) == NO_S_STEPS and s_inv == [0.0], "s_inv is not exactly 0 under --no_s")
    check(all(np.isfinite(float(r["loss"])) for r in rows), "--no_s loss rows")
    check(train_launches == {"cluster": 0, "stream": 0}, "--no_s training launched the kernel")

    model = state.model.eval()
    train = wave_eq.WaveEq(data_dir, cfg.nt_cond, cfg.nt_cond + cfg.nt_pred, True)
    cond = np.stack([train[i][0] for i in range(NO_S_EVAL_B)])
    n = WAVE_ROLLOUT_STEPS
    reset_launch_counts()
    with torch.inference_mode():
        out, t_codes, s, _ = model.get_forecast(torch.from_numpy(cond).to(dev), n)
    torch.cuda.synchronize()
    launches = dict(mlp_resnet_rollout.variant_launches)
    cpu_model = copy.deepcopy(model).cpu()
    exact_model = as_f64(copy.deepcopy(cpu_model))
    t_card = t_codes.cpu().transpose(0, 1).contiguous()
    with torch.inference_mode():
        ref, ref_t, ref_s, _ = cpu_model.get_forecast(torch.from_numpy(cond), n)
        # the decoder held alone, as phases 12a/13a hold each module: the
        # card's frames and the CPU's f32 decode of the card's T codes, each
        # against an f64 decode of the same codes
        decoded = cpu_model._decode_all(ref_s, None, t_card)
        exact = exact_model._decode_all(ref_s.double(), None, t_card.double())
    rel_t = step_rel_err(t_card, ref_t.transpose(0, 1))
    card = out.cpu().double()

    def rel(a, steps=slice(None)):
        return float((a[:, steps] - exact[:, steps]).abs().max()
                     / exact[:, steps].abs().max())

    # A trained --no_s model's T grows past ~1e9 by t+45 (no T penalty): its
    # decoder's f32 sums then cancel terms ~1e10 into far smaller frames, and
    # even the CPU's f32 decode is ~1e-4 of the frames' max from f64 there.
    # The frames are held to the module tolerance over the steps whose |T|
    # stays within NO_S_T_COMFORT, and to NO_S_DEC_TOL over all steps.
    comfort = t_card.abs().flatten(1).amax(1) <= NO_S_T_COMFORT  # t_card: (n, B, code)
    n_comfort = int(comfort.sum())
    rel_comfort = rel(card, comfort) if n_comfort else float("inf")
    rel_card, rel_cpu = rel(card), rel(decoded.double())
    rel_out = float((out.cpu() - ref).abs().max() / ref.abs().max())
    plan = card_plan(NO_S_EVAL_B, cfg.code_size_t, cfg.res_hidden_size, cfg.n_blocks)
    print(f"  f32 eval forecast B {NO_S_EVAL_B} x {n} frames on the card: launches {launches}, "
          f"plan {plan_text(plan)}; against the CPU: T codes step-relative {rel_t:.3e} "
          f"(tolerance {ROLLOUT_REL_TOL:g}), max |T| {float(ref_t.abs().max()):.4g}; the frames "
          f"against an f64 decode of the card's T codes: over the {n_comfort} steps with |T| <= "
          f"{NO_S_T_COMFORT:g} {rel_comfort:.3e} of their max (tolerance {ENC_F32_TOL:g}), over "
          f"all {n} {rel_card:.3e} (tolerance {NO_S_DEC_TOL:g}; the CPU's f32 decode "
          f"{rel_cpu:.3e}); card against the CPU's own forecast {rel_out:.3e}; S all ones on "
          f"both: {bool((s == 1).all() and (ref_s == 1).all())}")
    check(launches == {"cluster": 0, "stream": 1} and plan.variant == "stream",
          "the --no_s f32 forecast is not one streaming launch")
    check(bool(torch.isfinite(out).all()) and tuple(out.shape) == (NO_S_EVAL_B, n, 64, 64, 1),
          "the --no_s forecast's shape or values")
    check(rel_t <= ROLLOUT_REL_TOL and rel_comfort <= ENC_F32_TOL and rel_card <= NO_S_DEC_TOL,
          "the --no_s forecast, card against CPU")
    check(bool((s == 1).all() and (ref_s == 1).all()), "the --no_s S code is not all ones")
    return {"xp": xp, "launches": launches, "train_launches": train_launches}


def monitor_bitwise(dev, data_dir: str, work: str) -> dict:
    """Phase 14c: a short f32 flagship run with ``--monitor_stability``
    against the same run without it, under cudnn.deterministic: the final
    params, BatchNorm statistics and Adam state bitwise equal, one
    ``stability.csv`` row a checkpoint, one rollout launch a probe.  Returns
    the probed xp dir and the launches of each run."""
    argv = flagship_argv("", data_dir, MONITOR_EPOCHS, MONITOR_STEPS, "--precision", "f32",
                         "--batch_size", str(MONITOR_B), "--chkpt_interval", "1")
    states, logs, launches, xps = {}, {}, {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for probe in (False, True):
            cfg = config_from_args(build_parser().parse_args(argv)).validate()
            xps[probe] = os.path.join(work, "xps", "flagship_f32" + ("_probed" if probe else ""))
            cfg = dataclasses.replace(cfg, xp_dir=xps[probe])
            os.makedirs(cfg.xp_dir)
            cfg.save(os.path.join(cfg.xp_dir, "params.json"))
            logs[probe] = []
            reset_launch_counts()
            states[probe] = run_training(cfg, device=dev, log_every=1, log_fn=logs[probe].append,
                                         monitor_stability=probe)
            torch.cuda.synchronize()
            launches[probe] = dict(mlp_resnet_rollout.variant_launches)
    finally:
        torch.backends.cudnn.deterministic = False
    ta, tb = train_state_tensors(states[False]), train_state_tensors(states[True])
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    lines = {p: [m for m in logs[p] if m.startswith("epoch") and " step " in m] for p in logs}
    with open(os.path.join(xps[True], "stability.csv")) as f:
        header, *rows = f.read().splitlines()
    probes = [m for m in logs[True] if m.startswith("stability @")]
    print(f"--monitor_stability (f32 flagship B {MONITOR_B}, {MONITOR_EPOCHS} epochs x "
          f"{MONITOR_STEPS} steps, cudnn.deterministic): {len(differ)} of {len(ta)} tensors "
          f"(params, BatchNorm statistics, Adam state) differ from the run without it; loss "
          f"lines equal: {lines[True] == lines[False]}; launches {launches}; stability.csv "
          f"{header}: {rows}")
    for m in probes:
        print(f"  {m}")
    n_ckpt = MONITOR_EPOCHS
    check(states[True].model.training and not differ and lines[True] == lines[False]
          and len(lines[True]) == MONITOR_EPOCHS * MONITOR_STEPS,
          "--monitor_stability changed training")
    check(header.split(",")[:5] == ["step", "wall_s", "stability_gain", "stability_s_mean_abs",
                                    "stability_bn_max_var"] and len(rows) == n_ckpt
          and len(probes) == n_ckpt, "stability.csv has not one row a checkpoint")
    check(launches[False] == {"cluster": 0, "stream": 0}
          and launches[True] == {"cluster": n_ckpt, "stream": 0},
          "not one cluster launch a probe")
    return {"xp": xps[True], "launches": launches[True]}


def diagnose_on_card(xp: str, label: str, variant) -> tuple:
    """Phase 14b: the diagnose CLI over every checkpoint of ``xp`` on the
    card; each report's gains, norms and verdict against the CPU probe of
    the same checkpoint and batch.  ``variant``: the kernel each probe must
    launch once (None: none, a bf16 model).  Returns (launches, reports)."""
    argv = ["--xp_dir", xp, "--epoch", "all", "--batch_size", str(PROBE_B), "--n_steps",
            str(PROBE_STEPS)]
    print(f"diagnose [{label}]: python -m spatiotemporal_variable_separation_tpu_torch.cli."
          f"diagnose " + " ".join(argv))
    reset_launch_counts()
    reports = cli_diagnose.main(argv)
    torch.cuda.synchronize()
    launches = dict(mlp_resnet_rollout.variant_launches)
    expected = {v: (len(reports) if v == variant else 0) for v in launches}
    print(f"  {len(reports)} checkpoint(s), rollout launches {launches}")
    check(launches == expected, f"diagnose [{label}]: not one {variant} launch a checkpoint")
    if variant is None:
        return launches, reports
    worst = 0.0
    for name, rep in reports:
        model, cfg = load_for_eval(xp, name, device="cpu")
        cond = np.random.default_rng(0).standard_normal(
            (PROBE_B, cfg.nt_cond) + cfg.frame_shape).astype(np.float32)  # the CLI's batch
        ref = diagnose(model, None, cond, PROBE_STEPS, rep["horizon"], synthetic_cond=True)
        errs = [float(np.max(np.abs(np.asarray(rep[k], np.float64) - np.asarray(ref[k]))
                             / np.abs(np.asarray(ref[k], np.float64))))
                for k in ("t_norms", "gains", "s_mean_abs", "s_norm", "t0_norm")]
        worst = max(worst, *errs)
        print(f"  checkpoint {name}: gain/step {rep['gain_geomean']:.4f} (CPU "
              f"{ref['gain_geomean']:.4f}), verdict {rep['verdict']} (CPU {ref['verdict']}); "
              f"worst relative difference of the norms, gains and S statistics {max(errs):.3e}")
        check(ref["verdict"] == rep["verdict"], f"diagnose [{label}] {name}: verdicts differ")
    print(f"  card against CPU: worst relative difference {worst:.3e} (tolerance {PROBE_RTOL:g})")
    check(worst <= PROBE_RTOL, f"diagnose [{label}]: the probe disagrees with the CPU")
    return launches, reports


def supervised_train(dev, data_dir: str, work: str) -> dict:
    """Phase 14d: the port's train CLI under ``supervise``, in child
    processes: an uninterrupted run; the same run stopped once by the
    supervisor's deadline (SIGTERM, the guarded final save), then finished by
    a ``--resume`` relaunch; the two final checkpoints bitwise equal.  The
    supervisor reads a clock that jumps past the deadline once the stopped
    child prints step ``SUPERVISED_STOP_STEP``, so the stop lands at a known
    step on any host.  Returns the rollout launches that the children count
    and print."""
    entry_dir = os.path.join(work, "entry")
    os.makedirs(entry_dir)
    with open(os.path.join(entry_dir, "deterministic_train.py"), "w") as f:
        f.write(DETERMINISTIC_ENTRY)
    root = os.path.dirname(os.path.abspath(__file__))
    old_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([entry_dir, root] + ([old_path] if old_path
                                                                      else []))
    total = SUPERVISED_EPOCHS * SUPERVISED_STEPS
    xps = {k: os.path.join(work, "xps", f"supervised_{k}") for k in ("whole", "stopped")}
    offset = [0.0]
    real_time = cli_supervise.time
    cli_supervise.time = types.SimpleNamespace(monotonic=lambda: real_time.monotonic() + offset[0])
    launches = []

    def run(xp, *extra, stop_at=None, **kw):
        lines, t0 = [], time.monotonic()

        def log_fn(line):
            lines.append((time.monotonic() - t0, line))
            if line.startswith("rollout launches: "):
                launches.append(json.loads(line.split(": ", 1)[1]))
            if stop_at is not None and line.startswith(f"epoch 0 step {stop_at}:"):
                offset[0] += SUPERVISED_CLOCK_JUMP_S

        argv = flagship_argv(xp, data_dir, SUPERVISED_EPOCHS, SUPERVISED_STEPS,
                             "--log_every", "1", *extra)
        rc = cli_supervise.supervise(argv, log_fn=log_fn, entry="deterministic_train",
                                     startup_grace=0, **kw)
        return rc, lines

    try:
        t = time.perf_counter()
        rc, lines = run(xps["whole"])
        step_at = {int(m.split(" step ")[1].split(":")[0]): s for s, m in lines
                   if m.startswith("epoch ") and " step " in m}
        banner = next(s for s, m in lines if m.startswith("training:"))
        print(f"supervise, the uninterrupted run: rc {rc}, {len(lines)} lines in "
              f"{time.perf_counter() - t:.1f} s; the child's banner {banner:.1f} s after the "
              f"launch (interpreter, imports, the card, data and model), step lines from "
              f"{min(step_at.values()):.1f} s to {max(step_at.values()):.1f} s")
        check(rc == 0 and sorted(step_at) == list(range(1, total + 1)),
              "the supervised run did not finish")
        t = time.perf_counter()
        rc, lines = run(xps["stopped"], stop_at=SUPERVISED_STOP_STEP,
                        deadline_min=SUPERVISED_DEADLINE_MIN, stall_timeout=1e6)
        text = "\n".join(m for _, m in lines)
        stopped_at = int(torch.load(os.path.join(xps["stopped"], "checkpoints", "final",
                                                 "train_state.pt"), map_location="cpu",
                                    weights_only=True)["step"])
        print(f"supervise with deadline_min {SUPERVISED_DEADLINE_MIN:g}, its clock jumped "
              f"{SUPERVISED_CLOCK_JUMP_S:g} s once step {SUPERVISED_STOP_STEP} was out: rc {rc} "
              f"in {time.perf_counter() - t:.1f} s; the child saved 'final' at step {stopped_at}")
        for _, m in lines:
            if m.startswith("[supervise]") or m.startswith("interrupted"):
                print(f"  {m}")
        check(rc == 0 and "deadline reached" in text
              and "interrupted (Ctrl-C/SIGTERM) — saving final checkpoint" in text
              and SUPERVISED_STOP_STEP <= stopped_at < total,
              "the supervisor's deadline did not stop training mid-run with a final save")
        t = time.perf_counter()
        rc, lines = run(xps["stopped"], "--resume")
        text = "\n".join(m for _, m in lines)
        print(f"supervise, the --resume relaunch: rc {rc} in {time.perf_counter() - t:.1f} s; "
              f"resumed from step {stopped_at}: {f'resumed from step {stopped_at}' in text}")
        check(rc == 0 and f"resumed from step {stopped_at}" in text, "the supervised resume")
    finally:
        cli_supervise.time = real_time
        if old_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old_path
    cfg = ExperimentConfig.from_json_file(os.path.join(xps["whole"], "params.json"))
    states = {k: checkpoint.restore_checkpoint(xp, create_train_state(cfg, SUPERVISED_STEPS,
                                                                      device=dev), name="final")
              for k, xp in xps.items()}
    ta, tb = (train_state_tensors(states[k]) for k in ("whole", "stopped"))
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    print(f"  the stopped-and-resumed run against the uninterrupted one (cudnn.deterministic in "
          f"both children): steps {states['whole'].step} and {states['stopped'].step}; "
          f"{len(differ)} of {len(ta)} tensors (params, BatchNorm statistics, Adam state) differ "
          f"{differ[:3]}; rollout launches the three children counted: {launches}")
    check(states["whole"].step == states["stopped"].step == total and ta.keys() == tb.keys()
          and not differ, "the supervised stop and resume is not bitwise the uninterrupted run")
    check(len(launches) == 3, "a supervised child did not print its rollout launches")
    return {v: sum(n[v] for n in launches) for v in mlp_resnet_rollout.variant_launches}


def ops_tools(work: str, phase9_xp: str, wave_dir: str) -> None:
    """Phase 14e: summarize over 14's xp dirs, visualize over phase 9's eval
    archive, gen_synthetic mnist against the pinned sha256, and
    verify_corpus for mnist (on that stand-in), wave and chairs."""
    lines = []
    rows = cli_summarize.summarize_all(os.path.join(work, "xps"), log_fn=lines.append)
    for line in lines:
        print(f"  summarize: {line}")
    names = {r["name"]: r for r in rows}
    check(sorted(names) == sorted(os.listdir(os.path.join(work, "xps")))
          and all(r.get("steps_logged", 0) > 0 for r in rows)
          and names["flagship_f32_probed"].get("stability") is not None,
          "summarize over phase 14's experiments")

    from PIL import Image

    frames = os.path.join(work, "frames")
    cli_visualize.main(["--xp_dir", phase9_xp, "--n", "4", "--out", frames])
    pngs = sorted(os.listdir(frames))
    sizes = [Image.open(os.path.join(frames, p)).size for p in pngs]
    print(f"  visualize over phase 9's archive: {pngs} ({sizes[0][0]} x {sizes[0][1]} px)")
    check(len(pngs) >= 4 and all(p.endswith(".png") for p in pngs), "visualize")

    mnist = os.path.join(work, "mnist_standin")
    cli_gen_synthetic.main(["mnist", "--data_dir", mnist])
    raw = os.path.join(mnist, "MNIST", "raw")
    digests = {f: hashlib.sha256(open(os.path.join(raw, f), "rb").read()).hexdigest()
               for f in sorted(os.listdir(raw))}
    absent = {m: importlib.util.find_spec(m) is None for m in ("sklearn", "cv2", "h5py")}
    print(f"  gen_synthetic mnist: sha256 as pinned: {digests == MNIST_STANDIN_SHA256}; "
          f"absent on this machine: {absent}")
    check(digests == MNIST_STANDIN_SHA256, "the MNIST stand-in's files")
    check("sklearn" not in sys.modules and "cv2" not in sys.modules,
          "gen_synthetic mnist imported scikit-learn or cv2")
    cli_make_mnist_test.main(["--data_dir", mnist])
    chairs = os.path.join(work, "chairs_standin")
    cli_gen_synthetic.main(["chairs", "--data_dir", chairs, "--n_objects",
                            str(OPS_CHAIRS_OBJECTS)])
    for benchmark, data_dir in (("mnist", mnist), ("wave", wave_dir), ("chairs", chairs)):
        rc = cli_verify_corpus.main([benchmark, "--data_dir", data_dir])
        check(rc == 0, f"verify_corpus {benchmark}")


def ops_phase(ctx) -> dict:
    """Phase 14: ``--no_s``, the stability probe (``diagnose`` and
    ``--monitor_stability``) on the rollout kernel, ``supervise``,
    ``summarize``, ``visualize``, ``verify_corpus`` and ``gen_synthetic
    mnist``, in a working directory of its own, on phase 8's digits and bf16
    checkpoint, phase 9's eval archive in it, and ``ctx.small_wave``.
    Returns the kernels' launches on the new paths."""
    dev, data_dir, phase8_xp = ctx.dev, ctx.digits.data_dir, ctx.eval_archive
    wave_dir = ctx.small_wave
    with tempfile.TemporaryDirectory(dir=ctx.work) as work:
        t = time.perf_counter()

        def sub(label):
            nonlocal t
            print(f"phase {label}: {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()

        no_s = no_s_wave(dev, work, wave_dir)
        sub("14a")
        monitor = monitor_bitwise(dev, data_dir, work)
        sub("14c")
        flagship, _ = diagnose_on_card(monitor["xp"], "f32 flagship, cluster kernel", "cluster")
        wave, _ = diagnose_on_card(no_s["xp"], "f32 WaveEq --no_s, 3 blocks, streaming kernel",
                                   "stream")
        bf16, reports = diagnose_on_card(phase8_xp, "phase 8's bf16 flagship checkpoint", None)
        for name, rep in reports:
            print(f"  bf16 checkpoint {name}: gain/step {rep['gain_geomean']:.4f}, projected "
                  f"growth over t+{rep['horizon']} {rep['projected_growth_at_horizon']:.4g}x, "
                  f"mean|S| {float(rep['s_mean_abs']):.4g}, BatchNorm max running var "
                  f"{rep['bn']['max_var']:.4g}: verdict {rep['verdict']}")
        sub("14b")
        supervised = supervised_train(dev, data_dir, work)
        sub("14d")
        ops_tools(work, phase8_xp, wave_dir)
        sub("14e")
        return {"no_s": no_s["launches"], "no_s_train": no_s["train_launches"],
                "monitor": monitor["launches"], "flagship": flagship, "wave": wave, "bf16": bf16,
                "supervised": supervised}


# -- phase 15: data and tensor parallelism on one card ---------------------
# 15b's two processes share the card over gloo; 15a's group is one rank over
# NCCL.  One card cannot show NCCL across ranks or several hosts.
PAR_TIMEOUT_S = 600.0
PAR_BF16_STEPS = 3          # 15b's bf16 steps on each rank, its loss finite after them
# 15b, two ranks against one process on the card: the CPU test's tolerances
# (tests/test_torch_parallel_train.py): the loss within rel 1e-4, the
# rank-averaged gradients within 1e-4 of each layer's max |g|, the BatchNorm
# statistics within 1e-5 of each layer's max.  They hold in f64.  In f32
# (TF32 off) the loss and statistics hold them, but at full width the
# gradients of two f32 sums of other orders part by more (measured 1.45e-2
# of Es.stage_2's max, where the CPU test's small widths show 1e-5): each
# f32 step is then held to the f64 step at phase 6's f32 tolerance,
# TRAIN_GRAD_TOL.
PAR_LOSS_RTOL, PAR_GRAD_TOL, PAR_STATS_TOL = 1e-4, 1e-4, 1e-5
# 15c, tensor parallel (1, 2) against one process, one SGD step at lr 1e-2:
# the JAX package's tolerances (tests/test_tensor_parallel.py:110-134).
TP_SGD_LR, TP_LOSS_RTOL, TP_PARAM_ATOL = 1e-2, 1e-4, 2e-5
PAR_EVAL_RAGGED = 13        # 15d's ragged batch: padded to 14, two shards of 7


def par_seq(cfg) -> torch.Tensor:
    """Phase 15's fixed global batch, on the host: uniform noise from a seed,
    as the CPU test's (tests/torch_parallel_jobs.py:global_batch).  Phase 7's
    moving squares are mostly exact zeros, whose activations sit on the
    LeakyReLU kink: there two f32 sums of other orders flip branches (on the
    CPU at nf 8, B 8: gradients 1.9e-3 of a layer's max apart in f32, 1.6e-14
    in f64)."""
    seq = np.random.default_rng(1).random(
        (cfg.batch_size, cfg.nt_cond + cfg.nt_pred) + cfg.frame_shape, dtype=np.float32)
    return torch.from_numpy(seq)


def par_step_result(state, metrics) -> dict:
    """Metrics, whole gradients and params (gathered from their shards) and
    the BatchNorm statistics of a state after a step, on the host."""
    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().double().cpu()

    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: whole(p.grad) for n, p in state.model.named_parameters()},
            "params": {n: whole(p) for n, p in state.model.named_parameters()},
            "stats": bn_stats(state.model)}


def par_sgd_state(cfg, dev):
    state = create_train_state(cfg, steps_per_epoch=100, device=dev)
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=TP_SGD_LR)
    state.optimizer.lr_schedule = lambda step: TP_SGD_LR
    return state


def parallel_rank(out: str, t_launch: float) -> None:
    """One of 15b's two ranks, both on this card over gloo: (1) one f32 and
    one f64 step of the flagship on the global batch split in two, data
    parallel; (2) ``PAR_BF16_STEPS`` bf16 flagship steps.  Writes
    ``par_rank<r>.pt``: the results, the rollout kernel's launches over all
    of the rank's steps, and the seconds from ``t_launch`` (the parent's
    ``time.time()`` before the spawn) to each stage's end."""
    import torch.distributed as dist

    from spatiotemporal_variable_separation_tpu_torch.parallel import make_mesh, shard_batch

    reset_launch_counts()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, res = dist.get_rank(), {"seconds": {"in the rank's function": time.time() - t_launch}}
    dp = make_mesh()
    cfg = ExperimentConfig(**{**FLAGSHIP, "precision": "f32"})
    seq = par_seq(cfg)
    state = create_train_state(cfg, steps_per_epoch=100, device=dp.local_device)
    step = make_train_step(state.model, cfg, state.optimizer, dp)
    cond, target = shard_batch(dp, (seq[:, :cfg.nt_cond], seq[:, cfg.nt_cond:]))
    res["dp"] = par_step_result(state, step(state, cond, target, t_random=TRAIN_CHECK_T_RANDOM))
    res["dp"]["rows"] = cond.shape[0]
    res["seconds"]["f32 step"] = time.time() - t_launch
    del state, step
    state = create_train_state(cfg, steps_per_epoch=100, device=dp.local_device)
    as_f64(state.model)
    step = make_train_step(state.model, cfg, state.optimizer, dp)
    res["dp64"] = par_step_result(state, step(state, cond.double(), target.double(),
                                              t_random=TRAIN_CHECK_T_RANDOM))
    res["seconds"]["f64 step"] = time.time() - t_launch
    del state, step
    bf16 = ExperimentConfig(**FLAGSHIP)
    state = create_train_state(bf16, steps_per_epoch=100, device=dp.local_device)
    step = make_train_step(state.model, bf16, state.optimizer, dp)
    for _ in range(PAR_BF16_STEPS):
        m = step(state, cond, target)
    res["bf16_loss"] = float(m["loss"])
    res["seconds"]["bf16 steps"] = time.time() - t_launch
    res["launches"] = dict(mlp_resnet_rollout.variant_launches)
    torch.save(res, os.path.join(out, f"par_rank{rank}.pt"))


def tensor_parallel_world_one(dev) -> None:
    """15c: tensor parallel over the world-1 NCCL group, at (data 1, model 1).

    The card has one device, and gloo cannot carry DTensor's collectives of
    CUDA tensors: a two-rank gloo job on the card segfaulted in the
    functional collectives' ``wait_tensor`` of a ``full_tensor()`` (one probe
    run, torch 2.11.0+cu128), where plain ``all_gather_into_tensor`` worked.
    So the model axis has one rank.  JAX's rule shards nothing at a model
    size of 1, so the state takes the placements of the (1, 2) mesh of two
    ranks (``state_shardings`` of a one-process mesh naming the card twice):
    every kernel the two ranks would split is a DTensor, ``Shard`` on an
    axis of one rank, and runs through the DTensor Linear and the gathered
    convolutions.  One f32 SGD step against one process, at the JAX
    package's tolerances."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from spatiotemporal_variable_separation_tpu_torch.parallel import (
        make_mesh,
        shard_state,
        state_shardings,
    )
    from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        Mesh,
    )

    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = dev
    tp = Mesh(grid, (DATA_AXIS, MODEL_AXIS),
              DeviceMesh(dev.type, [[0]], mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))
    cfg = ExperimentConfig(**{**FLAGSHIP, "precision": "f32"})
    seq = par_seq(cfg).to(dev)
    cond, target = seq[:, :cfg.nt_cond], seq[:, cfg.nt_cond:]
    state = par_sgd_state(cfg, dev)
    shardings = state_shardings(state.model, make_mesh(devices=[dev, dev], model_parallel=2))
    shard_state(state, tp, shardings)
    sharded = sorted(n for n, p in state.model.named_parameters() if hasattr(p, "placements"))
    got = par_step_result(state, make_train_step(state.model, cfg, state.optimizer, tp,
                                                 shardings)(
        state, cond, target, t_random=TRAIN_CHECK_T_RANDOM))
    del state
    state = par_sgd_state(cfg, dev)
    one = par_step_result(state, make_train_step(state.model, cfg, state.optimizer)(
        state, cond, target, t_random=TRAIN_CHECK_T_RANDOM))
    del state
    rel = abs(got["metrics"]["loss"] - one["metrics"]["loss"]) / abs(one["metrics"]["loss"])
    moved = max(float((got["params"][n] - p).abs().max()) for n, p in one["params"].items())
    print(f"15c: tensor parallel (data 1, model 1) over {dist.get_backend()} on {dev}, f32 SGD "
          f"lr {TP_SGD_LR:g}, "
          f"B {cfg.batch_size}: {len(sharded)} weights DTensors with the (1, 2) mesh's "
          f"placements ({', '.join(sharded[:3])}, ...): loss relative {rel:.2e} (tolerance "
          f"{TP_LOSS_RTOL:g}), params after the step max |difference| {moved:.2e} (tolerance "
          f"{TP_PARAM_ATOL:g})")
    check(bool(sharded) and rel <= TP_LOSS_RTOL and moved <= TP_PARAM_ATOL,
          "tensor parallel (1, 1) disagrees with one process")


def world_one_nccl(dev, work: str) -> dict:
    """15a and 15c over a world-1 NCCL group on the card.  15a: data
    parallel, three bf16 flagship steps through DDP and the global
    BatchNorm, bitwise against the plain step under ``cudnn.deterministic``.
    15c: ``tensor_parallel_world_one``.  Returns the rollout kernel's
    launches over 15a and 15c, their plain steps included."""
    import torch.distributed as dist

    from spatiotemporal_variable_separation_tpu_torch.parallel import make_mesh
    from spatiotemporal_variable_separation_tpu_torch.parallel.distributed import (
        initialize_multihost,
    )

    reset_launch_counts()
    initialize_multihost("file://" + os.path.join(work, "nccl_world1"), 1, 0, device=dev)
    try:
        mesh = make_mesh()
        print(f"15a: process group {dist.get_backend()}, world {dist.get_world_size()}, mesh "
              f"{mesh.shape} on {mesh.entries}")
        cfg = ExperimentConfig(**FLAGSHIP)
        seq = par_seq(cfg).to(dev)
        cond, target = seq[:, :cfg.nt_cond], seq[:, cfg.nt_cond:]
        torch.backends.cudnn.deterministic = True
        results = {}
        for label, use in (("plain", None), ("ddp", mesh)):
            state = create_train_state(cfg, steps_per_epoch=100, device=dev)
            step = make_train_step(state.model, cfg, state.optimizer, use)
            losses = [float(step(state, cond, target)["loss"]) for _ in range(3)]
            results[label] = (losses, train_state_tensors(state))
            del state, step
        torch.backends.cudnn.deterministic = False
        (l_plain, t_plain), (l_ddp, t_ddp) = results["plain"], results["ddp"]
        differ = [k for k in t_plain if not torch.equal(t_plain[k], t_ddp[k])]
        print(f"  3 bf16 flagship steps (B {cfg.batch_size}, cudnn.deterministic): losses plain "
              f"{l_plain}, DDP + global BatchNorm {l_ddp}; {len(differ)} of {len(t_plain)} "
              f"tensors (params, BatchNorm statistics, Adam state) differ")
        check(l_plain == l_ddp and not differ,
              "the world-1 NCCL step is not the plain step bitwise")
        tensor_parallel_world_one(dev)
    finally:
        dist.destroy_process_group()
    return dict(mlp_resnet_rollout.variant_launches)


def two_processes_on_one_card(dev, work: str) -> dict:
    """15b: ``parallel_rank`` in two processes sharing the card over gloo,
    held against one process on the card."""
    from spatiotemporal_variable_separation_tpu_torch.parallel.distributed import launch

    t = time.perf_counter()
    launch(parallel_rank, (work, time.time()), [dev, dev], backend="gloo",
           timeout=PAR_TIMEOUT_S)
    print(f"15b: two ranks on {dev} over gloo ran in {time.perf_counter() - t:.1f} s "
          "(spawn and start-up included)")
    ranks = [torch.load(os.path.join(work, f"par_rank{r}.pt"), weights_only=False)
             for r in range(2)]
    for r, res in enumerate(ranks):
        print(f"  rank {r}, seconds from the spawn to the end of each stage: " + ", ".join(
            f"{k} {v:.1f}" for k, v in res["seconds"].items()))
    cfg = ExperimentConfig(**{**FLAGSHIP, "precision": "f32"})
    seq = par_seq(cfg).to(dev)
    cond, target = seq[:, :cfg.nt_cond], seq[:, cfg.nt_cond:]
    one = {}
    for label, dtype in (("dp", torch.float32), ("dp64", torch.float64)):
        state = create_train_state(cfg, steps_per_epoch=100, device=dev)
        if dtype == torch.float64:
            as_f64(state.model)
        one[label] = par_step_result(state, make_train_step(state.model, cfg, state.optimizer)(
            state, cond.to(dtype), target.to(dtype), t_random=TRAIN_CHECK_T_RANDOM))
        del state
    _, f32_vs_f64 = layer_rel_err(one["dp"]["grads"], one["dp64"]["grads"])
    print(f"  one process on the card, f32 against f64 gradients: worst {f32_vs_f64:.2e} of the "
          "layer's max")
    for r, res in enumerate(ranks):
        for label in ("dp", "dp64"):
            got, ref = res[label], one[label]
            rel = abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) / abs(
                ref["metrics"]["loss"])
            g_at, g_err = layer_rel_err(got["grads"], ref["grads"])
            s_at, s_err = layer_rel_err(got["stats"], ref["stats"])
            print(f"  rank {r}, data parallel {'f32 (TF32 off)' if label == 'dp' else 'f64'}, "
                  f"{res['dp']['rows']} of {cfg.batch_size} rows: loss "
                  f"{got['metrics']['loss']:.6f} against one process "
                  f"{ref['metrics']['loss']:.6f}, relative {rel:.2e} (tolerance "
                  f"{PAR_LOSS_RTOL:g}); gradients worst {g_err:.2e} of the layer's max at {g_at}; "
                  f"BatchNorm statistics worst {s_err:.2e} at {s_at} (tolerance "
                  f"{PAR_STATS_TOL:g})")
            check(rel <= PAR_LOSS_RTOL and s_err <= PAR_STATS_TOL,
                  "two ranks on the card disagree with one process")
            if label == "dp64":
                check(g_err <= PAR_GRAD_TOL, "f64 gradients of two ranks against one process "
                      f"(tolerance {PAR_GRAD_TOL:g})")
        _, g32 = layer_rel_err(res["dp"]["grads"], one["dp64"]["grads"])
        print(f"  rank {r}, f32 gradients against one process's f64: worst {g32:.2e} of the "
              f"layer's max (tolerance {TRAIN_GRAD_TOL:g}, as one process's f32: "
              f"{f32_vs_f64:.2e})")
        check(g32 <= TRAIN_GRAD_TOL and f32_vs_f64 <= TRAIN_GRAD_TOL,
              "f32 gradients against f64")
    a, b = (res["dp"] for res in ranks)
    check(a["metrics"] == b["metrics"], "the ranks log different losses")
    check(all(torch.equal(a["grads"][n], b["grads"][n]) for n in a["grads"]),
          "the ranks' averaged gradients differ")
    check(all(torch.equal(a["stats"][n], b["stats"][n]) for n in a["stats"]),
          "the ranks' BatchNorm statistics differ")
    print(f"  bf16 flagship, two processes sharing one card, B {FLAGSHIP['batch_size']} = "
          f"2 x {FLAGSHIP['batch_size'] // 2}: rank 0's loss after {PAR_BF16_STEPS} steps "
          f"{ranks[0]['bf16_loss']:.4f}")
    check(np.isfinite(ranks[0]["bf16_loss"]), "non-finite two-rank bf16 loss")
    return {v: sum(res["launches"][v] for res in ranks) for v in ranks[0]["launches"]}


def sharded_eval(dev, model, cfg, test_set) -> dict:
    """15d: the Evaluator over the mesh (cuda:0, cuda:0) against one device,
    on phase 9's f32 seed-0 model and test set at B 16 and a ragged batch."""
    from spatiotemporal_variable_separation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=[dev, dev])
    ev1, ev2 = Evaluator(model), Evaluator(model, mesh=mesh)
    n = cfg.nt_cond + 10
    batches = {"B 16": eval_batch(test_set, 0), f"ragged B {PAR_EVAL_RAGGED}":
               eval_batch(test_set, 1)[:PAR_EVAL_RAGGED]}
    launches = 0
    for label, items in batches.items():
        cond = np.stack([c for c, _ in items])
        shard = -(-cond.shape[0] // 2)
        plan = card_plan(shard, *model.t_resnet.flat_params()[0].shape, 1)
        reset_launch_counts()
        fc2, _ = ev2.forecast(cond, n)
        torch.cuda.synchronize()
        got = dict(mlp_resnet_rollout.variant_launches)
        fc1, _ = ev1.forecast(cond, n)
        print(f"15d: Evaluator over {mesh.entries}, {label}: rollout kernel launches {got} "
              f"(one a shard), each shard {shard} rows: {plan_text(plan)}")
        check(got == {"cluster": 2, "stream": 0}, "one cluster launch a shard")
        launches += got["cluster"]
        check(fc2.shape == fc1.shape, "sharded forecast shape")
        check_frames(fc2.cpu().numpy(), fc1.cpu().numpy(),
                     f"  sharded forecast against one device, {label}")
    return {"launches": launches}


def sharded_serving(dev, model, cfg) -> dict:
    """15e: ``Forecaster`` over the mesh (cuda:0, cuda:0), B 64 x 100,
    against one device."""
    from spatiotemporal_variable_separation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=[dev, dev])
    cond = np.random.default_rng(0).random((B, cfg.nt_cond) + cfg.frame_shape, dtype=np.float32)
    one = Forecaster(model, cfg, batch_size=B, n_forecast=N_FORECAST, device=dev)
    two = Forecaster(model, cfg, batch_size=B, n_forecast=N_FORECAST, mesh=mesh)
    plan = card_plan(B // 2, *model.t_resnet.flat_params()[0].shape, 1)
    reset_launch_counts()
    answers = {b: two.predict(cond[:b]) for b in REQUESTS}
    launches = dict(mlp_resnet_rollout.variant_launches)
    print(f"15e: Forecaster over {mesh.entries}, B {B} x {N_FORECAST}, requests of "
          f"{list(answers)} windows: rollout kernel launches {launches} (two a request), each "
          f"shard {B // 2} rows: {plan_text(plan)}")
    check(launches == {"cluster": 2 * len(REQUESTS), "stream": 0}, "two launches a request")
    for b, a in answers.items():
        check_frames(a, one.predict(cond[:b]), f"  {b}-window answer over the mesh against one "
                     "device")
    return {"launches": launches["cluster"]}


def eval_cli_devices(dev, work: str, data_dir: str) -> dict:
    """15f: ``test_wave`` on one card: ``--devices 2`` raises JAX's
    ``requested 2 devices, have 1``, ``--devices 1`` runs (an f32 seed-0
    checkpoint of the wave recipe on the small corpus in ``data_dir``)."""
    xp = os.path.join(work, "par_wave_xp")
    cfg = wave_config("wave", data_dir, precision="f32", xp_dir=xp)
    os.makedirs(xp)
    cfg.save(os.path.join(xp, "params.json"))
    checkpoint.save_checkpoint(xp, create_train_state(cfg, 10, device=dev), name="final")
    argv = ["--xp_dir", xp, "--data_dir", data_dir]
    try:
        cli_test_wave.main(argv + ["--devices", "2"])
        raised = None
    except ValueError as e:
        raised = str(e)
    print(f"15f: test_wave --devices 2 on {torch.cuda.device_count()} card: raised {raised!r}")
    check(raised == f"requested 2 devices, have {torch.cuda.device_count()}",
          "--devices 2 on one card")
    reset_launch_counts()
    means = cli_test_wave.main(argv + ["--devices", "1"])
    launches = dict(mlp_resnet_rollout.variant_launches)
    print(f"  test_wave --devices 1: mse_t40 {means['mse_t40']:.6g}, rollout kernel launches "
          f"{launches}")
    check(np.isfinite(means["mse_t40"]) and launches["stream"] >= 1 and launches["cluster"] == 0,
          "test_wave --devices 1")
    return {"launches": launches["stream"]}


def parallel_phase(ctx) -> dict:
    """Phase 15: data and tensor parallelism on one card, in a working
    directory of its own, on phase 3's f32 seed-0 model, phase 9's test set
    and ``ctx.small_wave``.  Returns the kernels' launches on the sharded
    paths and on the parallel training paths (15a-c)."""
    dev, model, cfg = ctx.dev, ctx.seed0.model, ctx.seed0.cfg
    data_dir, wave_dir = ctx.test_set, ctx.small_wave
    with tempfile.TemporaryDirectory(dir=ctx.work) as work:
        t = time.perf_counter()

        def sub(label):
            nonlocal t
            print(f"phase {label}: {time.perf_counter() - t:.1f} s")
            t = time.perf_counter()

        train = world_one_nccl(dev, work)
        sub("15a,c")
        ranks = two_processes_on_one_card(dev, work)
        train = {v: train[v] + ranks[v] for v in train}
        print(f"15a-c: rollout kernel launches {train}: the parallel training paths run the "
              "integrator module under autograd")
        check(train == {"cluster": 0, "stream": 0}, "training launched the kernel")
        sub("15b")
        test_set = MovingMNIST.make_dataset(data_dir, 64, cfg.nt_cond, cfg.nt_cond + 10, 4, True,
                                            cfg.n_object, train=False)
        ev = sharded_eval(dev, model, cfg, test_set)
        sub("15d")
        serve = sharded_serving(dev, model, cfg)
        sub("15e")
        clis = eval_cli_devices(dev, work, wave_dir)
        sub("15f")
    return {"eval": ev["launches"], "serve": serve["launches"], "test_wave": clis["launches"],
            "train": train}


# -- phase 16: the measurement programs ------------------------------------------
# Each at the least depth its flags take (each runs at full depth as a command
# of its own): the bench at 1 + 5 steps (of 5 + 50; 5 steps for its five
# timing blocks, which 16a checks), the trace tool at 1 + 1 steps (of 5 + 50)
# with its 3 traced, the remat tool's two B 32 rows at 1 + 1 steps (of 3 +
# 20), the serving tool at 1 end-to-end call and 1 back to back (of 30 and 10).
BENCH_ARGV = ["--warmup", "1", "--steps", "5"]
TRACE_ARGV = ["--warmup", "1", "--steps", "1"]
REMAT_ARGV = ["--rows", "t95_b32", "t95_b32_remat", "--warmup", "1", "--steps", "1"]
SERVING_ARGV = ["--iters", "1", "--amortized_k", "1"]


def run_main(label: str, main, argv: list) -> tuple:
    """A program's ``main(argv)`` in this process, its standard output
    passed through, then ``label`` with its seconds and rollout-kernel
    launches.  Returns (its output, seconds, those launches by variant)."""
    reset_launch_counts()
    t = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    seconds = time.perf_counter() - t
    launches = dict(mlp_resnet_rollout.variant_launches)
    print(out.getvalue(), end="")
    print(f"{label}: {seconds:.2f} s, rollout kernel launches {launches}")
    return out.getvalue(), seconds, launches


def run_program(label: str, main, argv: list) -> tuple:
    """Phase 16: ``run_main``.  Returns (the program's last line, parsed as
    JSON; its rollout-kernel launches by variant)."""
    text, _, launches = run_main(f"phase 16 {label}", main, argv)
    return json.loads(text.strip().splitlines()[-1]), launches


def positive(line: dict, keys, what: str) -> None:
    for k in keys:
        check(line[k] is not None and np.isfinite(line[k]) and line[k] > 0,
              f"{what}: {k} is {line[k]}, not a finite positive number")


def measurement_programs(ctx) -> dict:
    """Phase 16: the port's bench and its three tools, each through its
    ``main``, in a working directory of its own; returns each one's
    rollout-kernel launches by variant."""
    with tempfile.TemporaryDirectory(dir=ctx.work) as work:
        launches = {}
        line, launches["bench"] = run_program("a, bench", port_bench.main, BENCH_ARGV)
        positive(line, ("value", "step_ms", "mfu", "hbm_gb_per_step", "hbm_costmodel_bw_ratio",
                        "fused_datagen_samples_per_sec_per_chip", "device_busy_ms",
                        "kernels_per_step", "tflops_per_step"), "bench")
        check(np.isfinite(line["final_loss"]) and len(line["step_ms_blocks"]) == 5, "bench line")
        spread = max(line["step_ms_blocks"]) / min(line["step_ms_blocks"]) - 1
        print(f"  bench: {line['value']:.1f} samples/s, {line['step_ms']:.3f} ms/step (blocks: "
              f"{', '.join(f'{v:.3f}' for v in line['step_ms_blocks'])}; spread {spread:.1%}), "
              f"mfu {line['mfu']:.4f}, {line['hbm_gb_per_step']:.3f} GB a step, device busy "
              f"{line['device_busy_ms']:.3f} ms of {line['kernels_per_step']:.0f} kernels")

        trace_dir = os.path.join(work, "trace")
        line, launches["trace"] = run_program("b, trace_flagship", trace_flagship.main,
                                              ["--trace_dir", trace_dir, *TRACE_ARGV])
        positive(line, ("step_ms", "static_hbm_gb_per_step", "static_bw_utilization", "n_ops",
                        "trace_busy_ms", "trace_kernels"), "trace_flagship")
        size = os.path.getsize(os.path.join(trace_dir, "trace.json"))
        print(f"  trace_flagship: Chrome trace of 3 steps, {size / 1e6:.1f} MB")

        # cudnn.deterministic: remat recomputes the same kernels, so the two
        # rows' losses are then bitwise equal.
        torch.backends.cudnn.deterministic = True
        try:
            rows, launches["remat"] = run_program("c, bench_horizon_remat",
                                                  bench_horizon_remat.main, REMAT_ARGV)
        finally:
            torch.backends.cudnn.deterministic = False
        plain, remat = rows["t95_b32"], rows["t95_b32_remat"]
        check("oom" not in plain and "oom" not in remat, "a B 32 remat row ran out of memory")
        rel = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
        print(f"  remat rows (cudnn.deterministic): loss {plain['loss']!r} without, "
              f"{remat['loss']!r} with remat, relative {rel:.2e} (bitwise: {rel == 0}; "
              f"tolerance {TRAIN_LOSS_RTOL:g}); peak {plain['peak_gb']:.2f} against "
              f"{remat['peak_gb']:.2f} GB")
        check(rel <= TRAIN_LOSS_RTOL, "the remat rows' losses disagree")

        line, launches["serving"] = run_program("d, bench_serving_rollout",
                                                bench_serving_rollout.main, SERVING_ARGV)
        for v, err in line["kernel_max_step_rel_err"].items():
            print(f"  serving tool, {v} kernel against the plain rollout: step-relative {err:.3e} "
                  f"(tolerance {ROLLOUT_REL_TOL:g})")
            check(err <= ROLLOUT_REL_TOL, f"the serving tool's {v} kernel disagrees with plain")
        check(line["serve_launches"]["bf16"] == {"cluster": 0, "stream": 0}
              and line["serve_launches"]["f32"]["cluster"] > 0
              and launches["serving"]["stream"] > 0, "the serving tool's launches")
        for k in ("bench", "trace", "remat"):
            check(launches[k] == {"cluster": 0, "stream": 0}, f"{k} launched the rollout kernel")
        return launches


# -- phase 17: a migrated reference experiment on the card ----------------------
# The flagship at its full width in f32 (bench.py's config), imported from a
# stand-in of the reference's experiment layout.  The CPU's forecast, held
# against the card's first rows, covers these windows (all 100 steps; 4
# windows took 0.42 s on the card machine's host).
MIGRATED_CPU_WINDOWS = 16


def stand_in_reference(model, rng: np.random.Generator) -> dict:
    """17a: the reference's four modules as pickles of plain ``torch.nn``
    layers, one for each parameterized layer of ``model``'s module in its
    registration order (the reference's own order), holding ``model``'s
    weights, with BatchNorm statistics drawn from ``rng`` in the JAX
    package's ranges (``tests/test_import_torch.py:43-51``)."""
    modules = {}
    for key, _ in REFERENCE_FILES:
        layers = collections.OrderedDict()
        for i, (_, kind, m) in enumerate(reference_units(getattr(model, key))):
            if kind == "dense":
                layer = torch.nn.Linear(m.in_features, m.out_features)
            elif kind == "bn":
                layer = torch.nn.BatchNorm2d(m.num_features)
                n = m.num_features
                layer.running_mean.copy_(torch.from_numpy(
                    rng.standard_normal(n).astype(np.float32) * 0.3))
                layer.running_var.copy_(torch.from_numpy(
                    rng.random(n).astype(np.float32) * 1.5 + 0.25))
            else:
                cls = torch.nn.Conv2d if kind == "conv" else torch.nn.ConvTranspose2d
                layer = cls(m.in_channels, m.out_channels, m.kernel_size, m.stride, m.padding)
            with torch.no_grad():
                layer.weight.copy_(m.weight)
                layer.bias.copy_(m.bias)
            layers[str(i)] = layer
        modules[key] = torch.nn.Sequential(layers).eval()
    return modules


def same_tensors(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def migrated_experiment(ctx) -> dict:
    """Phase 17: a reference experiment at the flagship's full width, made
    as a stand-in (17a), imported through ``cli.import_torch`` (17b), served
    on the card through ``Forecaster`` and held against its CPU forecast
    (17c), exported and imported again (17d), with the kernels loaded from
    the root ``enable_compilation_cache`` resolves (17e), in a working
    directory of its own.  Returns the cluster kernel's launches while
    serving it."""
    dev, libs = ctx.dev, ctx.libs
    with tempfile.TemporaryDirectory(dir=ctx.work) as work:
        cfg = ExperimentConfig(**{**FLAGSHIP, "precision": "f32"})
        seed0 = build_separable_network(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
        modules = stand_in_reference(seed0, np.random.default_rng(17))
        ref = os.path.join(work, "reference_xp")
        os.makedirs(ref)
        params = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "precision"}
        with open(os.path.join(ref, "params.json"), "w") as f:
            json.dump(params, f)
        for key, stem in REFERENCE_FILES:
            torch.save(modules[key], os.path.join(ref, f"{stem}.pt"))
        ref_mb = sum(os.path.getsize(os.path.join(ref, f"{stem}.pt"))
                     for _, stem in REFERENCE_FILES) / 1e6
        print(f"phase 17a: stand-in reference experiment, {cfg.code_size_s}/{cfg.code_size_t} "
              f"codes, nf {cfg.enc_hidden_size}, MLP-ResNet {cfg.n_blocks} block H "
              f"{cfg.res_hidden_size}: four pickles of plain torch.nn layers, {ref_mb:.1f} MB, "
              f"params.json without precision")

        # -- 17b. import ----------------------------------------------------------
        xp = os.path.join(work, "migrated_xp")
        _, import_s, launches_import = run_main("  phase 17b, python -m ...cli.import_torch",
                                                cli_import_torch.main,
                                                ["--ref_xp_dir", ref, "--xp_dir", xp])
        check(launches_import == {"cluster": 0, "stream": 0},
              "the import launched the rollout kernel")
        ckpt_mb = os.path.getsize(os.path.join(xp, "checkpoints", "final", "train_state.pt")) / 1e6
        t = time.perf_counter()
        cpu_model, cpu_cfg = load_for_eval(xp, device="cpu")
        cpu_load_s = time.perf_counter() - t
        check(cpu_cfg.precision == "f32", "the import did not pin f32")
        for key, _ in REFERENCE_FILES:
            check(same_tensors(unit_tensors(getattr(cpu_model, key)), unit_tensors(modules[key])),
                  f"imported {key} differs from the stand-in")
        print(f"phase 17b: imported weights and BatchNorm statistics bitwise the stand-in's; "
              f"checkpoint {ckpt_mb:.1f} MB, loaded on the CPU in {cpu_load_s:.2f} s")

        # -- 17c. serve it on the card --------------------------------------------
        t = time.perf_counter()
        model, _ = load_for_eval(xp, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        fc = Forecaster(model, cpu_cfg, batch_size=B, n_forecast=N_FORECAST, device=dev)
        cond = np.random.default_rng(17).random((B, cfg.nt_cond) + cfg.frame_shape,
                                                dtype=np.float32)
        reset_launch_counts()
        answers = {b: fc.predict(cond[:b]) for b in REQUESTS}
        served = dict(mlp_resnet_rollout.variant_launches)
        print(f"phase 17c: load_for_eval on the card {load_s:.2f} s; requests of {list(answers)} "
              f"windows, rollout kernel launches {served}")
        check(served == {"cluster": len(answers), "stream": 0},
              "one cluster-kernel launch per request of the migrated experiment")
        for b, a in answers.items():
            check(a.shape == (b, N_FORECAST) + cfg.frame_shape and bool(np.isfinite(a).all())
                  and bool(((a >= 0) & (a <= 1)).all()), f"migrated forecast for {b}")
        n_cpu = MIGRATED_CPU_WINDOWS
        t = time.perf_counter()
        cpu_frames = Forecaster(cpu_model, cpu_cfg, n_cpu, N_FORECAST, device="cpu").predict(
            cond[:n_cpu])
        cpu_s = time.perf_counter() - t
        with torch.inference_mode():
            t_card = model.get_forecast(torch.from_numpy(cond[:n_cpu]).to(dev), N_FORECAST)[1]
            t_cpu = cpu_model.get_forecast(torch.from_numpy(cond[:n_cpu]), N_FORECAST)[1]
        rel = step_rel_err(t_card.transpose(0, 1).cpu(), t_cpu.transpose(0, 1))
        print(f"  T codes, card kernel against the CPU's plain rollout ({n_cpu} windows): "
              f"step-relative {rel:.3e} (tolerance {ROLLOUT_REL_TOL:g}); the CPU forecast "
              f"took {cpu_s:.2f} s")
        check(rel <= ROLLOUT_REL_TOL, "the migrated experiment's T codes disagree card vs CPU")
        check_frames(answers[B][:n_cpu], cpu_frames,
                     f"migrated forecast on the card vs its CPU forecast ({n_cpu} windows)")

        # -- 17d. export, and import again ----------------------------------------
        fresh = stand_in_reference(build_separable_network(
            cfg, torch.device("cpu"), torch.Generator().manual_seed(1)), np.random.default_rng(18))
        saved_builder = export_mod.build_reference_modules
        # The reference's factory is not on the card machine: the stand-in builder
        # takes its place, with other weights, so nothing of 17a survives in it.
        export_mod.build_reference_modules = lambda c, reference_root=None: fresh
        try:
            out = os.path.join(work, "exported_xp")
            _, export_s, launches_export = run_main(
                "  phase 17d, python -m ...cli.export_torch", cli_export_torch.main,
                ["--xp_dir", xp, "--ref_xp_dir", out])
        finally:
            export_mod.build_reference_modules = saved_builder
        check(launches_export == {"cluster": 0, "stream": 0},
              "the export launched the rollout kernel")
        exported = {key: torch.load(os.path.join(out, f"{stem}.pt"), weights_only=False)
                    for key, stem in REFERENCE_FILES}
        for key, _ in REFERENCE_FILES:
            check(not exported[key].training and same_tensors(unit_tensors(exported[key]),
                                                              unit_tensors(modules[key])),
                  f"exported {key} differs from the stand-in it was imported from")
        back = os.path.join(work, "reimported_xp")
        _, reimport_s, reimport_launches = run_main(
            "  phase 17d, the export through cli.import_torch", cli_import_torch.main,
            ["--ref_xp_dir", out, "--xp_dir", back])
        check(reimport_launches == {"cluster": 0, "stream": 0},
              "the second import launched the rollout kernel")
        converters = {v: launches_import[v] + launches_export[v] + reimport_launches[v]
                      for v in ("cluster", "stream")}
        again, _ = load_for_eval(back, device="cpu")
        check(same_tensors(list(again.state_dict().values()),
                           list(cpu_model.state_dict().values())),
              "export then import is not the identity")
        print(f"phase 17d: exported {out} and imported it again ({reimport_s:.2f} s): bitwise the "
              f"first import")

        # -- 17e. the kernels' build root --------------------------------------------
        resolved = enable_compilation_cache()
        root = compile_cache.build_root()
        loaded = {name: os.path.realpath(lib._name) for name, lib in _build._LOADED.items()}
        print(f"phase 17e: enable_compilation_cache() -> {resolved}; build root {root}; "
              f"libraries loaded from {sorted(loaded.values())}")
        for name, lib in libs.items():
            check(lib.parent.parent == root and _build.library_path(name) == lib,
                  f"{name}: phase 2 built {lib}, outside the resolved root {root}")
        check(loaded and all(path == os.path.realpath(libs[name]) for name, path in loaded.items()),
              "a kernel was loaded from outside phase 2's libraries")
        print(f"phase 17: import {import_s:.2f} s, export {export_s:.2f} s, load on the card "
              f"{load_s:.2f} s, checkpoint {ckpt_mb:.1f} MB")
        return {"launches": served, "converter_launches": converters,
                "import_s": import_s, "export_s": export_s,
                "load_s": load_s, "checkpoint_mb": ckpt_mb}


# -- phase 19: the decoder's transposed-conv kernel --------------------------------------

# The serving shape (B 64 x 100 frames, one eval decode fold) and an Evaluator's (B 16 x
# 10); the f64 plain version on the CPU runs on the first DECODER_F64_FRAMES frames of
# the serving shape (all of it is ~1.3 TFLOP), all frames of the Evaluator's.  The
# frames are the seed-0 model's, step-major: the first 64 are step 0's.  By the late
# steps its T codes reach ~1e7 (see ROLLOUT_REL_TOL), where any f32 sum order moves a
# sigmoid output near its midpoint visibly (the kernel and cuDNN part by up to ~2e-2 of
# a frame there): the last 64 frames' gaps to f64, the kernel's and cuDNN's, are
# printed beside, and not held to a limit.
DECODER_SHAPES = {"serving": B * N_FORECAST, "evaluator": EVAL_B * 10}
DECODER_F64_FRAMES = 64
# A stage's output against the f64 plain version, relative to the stage's largest
# output: 3xTF32 keeps ~22 bits of each operand and the K tiles' sums are added in
# f32, so the kernel errs as an f32 product does (on an H100: the kernel 1.3e-7 to
# 4.7e-7, cuDNN's f32 path 1.4e-7 to 7.7e-7 at both shapes; one TF32 product ~1e-4,
# and 3xTF32 with every K tile summed by the tensor cores 1.5e-5 at K 2,048).
DECODER_STAGE_TOL = 2e-6
# The serving cell's frame_gap over its calibration seeds: a fifth of its limit (5e-5).
DECODER_FRAME_GAP_TOL = 1e-5
SERVE_CALIBRATION_SEEDS = (11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 2147483659, 3000000017)
TF32_PEAK = 494.7e12  # dense TF32 on an H100 SXM; 3xTF32 does a third of it


def decoder_stages(model) -> list:
    """(name, block, act, NCHW out) of each stage of a DCGAN64Decoder, as its kernel
    route runs them."""
    dec = model.decoder
    blocks = [("first_upconv", dec.first_upconv), ("up_0", dec.up_0), ("up_1", dec.up_1),
              ("up_2", dec.up_2), ("to_frame", dec.to_frame)]
    return [(name, block, dec.last_activation if name == "to_frame" else block.act_name,
             name == "to_frame") for name, block in blocks]


def stage_cost(block, x: torch.Tensor) -> tuple:
    """(FLOPs, bytes read and written once) of one stage on NHWC input x."""
    n, h, w, cin = x.shape
    cout = block.conv.weight.shape[1]
    out_pixels = n * 16 if h == 1 else n * 4 * h * w
    flops = 2 * out_pixels * cout * cin * (1 if h == 1 else 4)  # taps an output pixel
    nbytes = 4 * (x.numel() + block.conv.weight.numel() + out_pixels * cout)
    return flops, nbytes


def decoder_kernel_stages(ctx, model, z: torch.Tensor, f64_frames: int) -> dict:
    """Each stage of the seed-0 flagship's decoder on codes z, through the kernel: its
    gap to the f64 plain version on the CPU (first f64_frames frames) and to cuDNN's
    f32 F.conv_transpose2d + BatchNorm + activation on the card, and the times of
    the kernel, the plain version and that library path, in turns, beside the
    stage's bound."""
    out = {}
    h = z.reshape(z.shape[0], 1, 1, z.shape[-1]).contiguous()
    for name, block, act, nchw in decoder_stages(model):
        conv = block.conv
        stride, padding = conv.stride[0], conv.padding[0]
        bn = block.bn
        stats = None if bn is None else BatchNormStats(bn.running_mean, bn.running_var,
                                                       bn.weight, bn.bias, bn.eps)
        run = lambda: block.fused_transposed(h, act=act, out_nchw=nchw)  # noqa: E731
        got = run()

        def library():
            y = torch.nn.functional.conv_transpose2d(h.permute(0, 3, 1, 2), conv.weight,
                                                     conv.bias, stride=stride, padding=padding)
            if stats is not None:
                y = torch.nn.functional.batch_norm(y, stats.mean, stats.var, stats.weight,
                                                   stats.bias, False, 0.0, stats.eps)
            return activation(act)(y)

        def plain():
            return transposed_conv_reference(h, conv.weight, conv.bias, stats, act,
                                             stride=stride, padding=padding, out_nchw=nchw)

        lib = library()
        lib = lib if nchw else lib.permute(0, 2, 3, 1)
        scale = float(lib.abs().max())
        f64 = lambda t: t.detach().double().cpu()  # noqa: E731
        ref = transposed_conv_reference(
            f64(h[:f64_frames]), f64(conv.weight), f64(conv.bias),
            None if stats is None else BatchNormStats(*(f64(v) for v in stats[:4]), stats.eps),
            act, stride=stride, padding=padding, out_nchw=nchw)
        gap_f64 = float((f64(got[:f64_frames]) - ref).abs().max()) / float(ref.abs().max())
        gap_lib = float((got - lib).abs().max()) / scale
        late = transposed_conv_reference(
            f64(h[-f64_frames:]), f64(conv.weight), f64(conv.bias),
            None if stats is None else BatchNormStats(*(f64(v) for v in stats[:4]), stats.eps),
            act, stride=stride, padding=padding, out_nchw=nchw)
        late_scale = float(late.abs().max())
        gap_late = float((f64(got[-f64_frames:]) - late).abs().max()) / late_scale
        gap_late_lib = float((f64(lib[-f64_frames:]) - late).abs().max()) / late_scale
        flops, nbytes = stage_cost(block, h)
        frame = conv.weight.shape[1] <= 4 and stride == 2
        peak = ctx.flops_peak if frame else TF32_PEAK / 3
        bound_ms = max(flops / peak, nbytes / ctx.bw_peak) * 1e3
        times, _ = in_turns({"kernel": run, "plain": plain, "library": library}, reps=3, inner=2)
        ms = times["kernel"]
        out[name] = {"shape": list(h.shape), "gap_f64": gap_f64, "gap_cudnn": gap_lib,
                     "gap_f64_last": gap_late, "cudnn_gap_f64_last": gap_late_lib, "ms": ms,
                     "plain_ms": times["plain"], "library_ms": times["library"],
                     "bound_ms": bound_ms,
                     "bound_by": ("f32 FMAs" if frame else "3xTF32")
                     if flops / peak >= nbytes / ctx.bw_peak else "bytes",
                     "tflops": flops / ms / 1e9}
        row = out[name]
        print(f"  {name} {tuple(h.shape)} -> {tuple(got.shape)}: against f64 "
              f"plain {gap_f64:.2e} (tolerance {DECODER_STAGE_TOL:g}), against cuDNN f32 "
              f"{gap_lib:.2e}; last {f64_frames} frames against f64: kernel {gap_late:.2e}, "
              f"cuDNN {gap_late_lib:.2e}; kernel {ms:.4f} ms ({row['tflops']:.1f} "
              f"TFLOP/s), bound {bound_ms:.4f} ms by {row['bound_by']} "
              f"({bound_ms / ms:.1%}), plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms")
        check(bool(torch.isfinite(got).all()), f"non-finite {name} output")
        check(gap_f64 <= DECODER_STAGE_TOL, f"{name}: kernel against the f64 plain version")
        h = got
        del lib, ref
    out["total_ms"] = sum(v["ms"] for v in out.values() if isinstance(v, dict))
    out["library_total_ms"] = sum(v["library_ms"] for v in out.values() if isinstance(v, dict))
    return out


def serve_calibration_gaps() -> list:
    """The serving cell's frame_gap on its calibration seeds, each from
    ``benchmark/calibrate.py`` (its set-up, a 2 s window and the comparison a run makes)."""
    cmd = [sys.executable, "benchmark/calibrate.py", "--workload", "mnist_dcgan.serve_f32",
           "--mode", "program", "--seconds", "2", "--seeds",
           *map(str, SERVE_CALIBRATION_SEEDS)]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    check(run.returncode == 0, f"calibrate.py exited {run.returncode}: {run.stderr[-2000:]}")
    lines = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    check(len(lines) == len(SERVE_CALIBRATION_SEEDS), "a calibrate.py line a seed")
    return [line["numbers"]["frame_gap"] for line in lines]


def decoder_kernel_phase(ctx) -> dict:
    """Phase 19: the DCGAN decoder's transposed convs through ``ops/transposed_conv.py``,
    on phase 3's seed-0 model."""
    dev, model, cfg = ctx.dev, ctx.seed0.model, ctx.seed0.cfg
    rng = np.random.default_rng(19)
    cond = rng.random((B, cfg.nt_cond) + cfg.frame_shape, dtype=np.float32)
    cond_dev = torch.from_numpy(cond).to(dev)
    result = {}
    with torch.inference_mode():
        s_code = model.encode_s(cond_dev)
        t_codes = model.get_forecast(cond_dev, N_FORECAST)[1].transpose(0, 1)  # (n, B, code)
        for label, frames in DECODER_SHAPES.items():
            n = frames // B if frames % B == 0 else None
            if n is not None:  # B 64 x 100: every (S, T_t) pair of the forecast
                z_t, z_s = t_codes.reshape(-1, t_codes.shape[-1]), s_code.repeat(n, 1)
            else:  # B 16 x 10: the first 16 windows' first 10 steps
                z_t = t_codes[:10, :EVAL_B].reshape(-1, t_codes.shape[-1])
                z_s = s_code[:EVAL_B].repeat(10, 1)
            z = torch.cat([z_s, z_t], dim=1).contiguous()
            print(f"decoder stages at the {label} shape ({z.shape[0]} frames):")
            result[label] = decoder_kernel_stages(
                ctx, model, z, min(DECODER_F64_FRAMES, frames) if label == "serving" else frames)
            print(f"  kernel {result[label]['total_ms']:.3f} ms over the five stages, cuDNN's "
                  f"library path {result[label]['library_total_ms']:.3f} ms")
    fc = Forecaster(model, cfg, batch_size=B, n_forecast=N_FORECAST, device=dev)
    transposed_conv.launches = 0
    full = fc.predict(cond)
    result["launches_request"] = transposed_conv.launches
    print(f"transposed_conv launches in one B {B} x {N_FORECAST} request: "
          f"{result['launches_request']} (one decode fold, one a stage)")
    check(result["launches_request"] == 5, "five launches a decode fold")
    # Smaller requests: the encoders run the padded batch, the rollout and the decoder
    # only the rows asked for (``rows_computed``, read from the span log, which a
    # profiler on the host alone fills).
    t_rows = time.perf_counter()
    result["rows_bitwise"], result["rows_launches"] = {}, {}
    for b in ROW_REQUESTS:
        transposed_conv.launches = mlp_resnet_rollout.launches = 0
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            part = fc.predict(cond[:b])
        records = {r.name: r.counts for r in span_log()[-4:]}
        launches = (transposed_conv.launches, mlp_resnet_rollout.launches)
        result["rows_bitwise"][b] = bool(np.array_equal(part, full[:b]))
        result["rows_launches"][b] = launches
        print(f"a {b}-window request: rows computed {records['predict']['rows_computed']}, "
              f"frames bitwise the {B}-window request's first rows (default cuDNN algorithms) "
              f"{result['rows_bitwise'][b]}, transposed_conv launches {launches[0]}, rollout "
              f"launches {launches[1]}, copy back {records['copy_back']}")
        check(records["predict"] == {"rows": b, "rows_computed": b},
              f"a {b}-window request computed {records['predict']}")
        check(records["copy_back"] == {"pinned": 1} and part.base.is_pinned(),
              f"a {b}-window request's answer is not in page-locked memory")
        check(result["rows_bitwise"][b], f"a {b}-window request differs from the full one's rows")
        check(launches == (5, 1), f"a {b}-window request's launches {launches}, not (5, 1)")
    result["padded_bitwise"] = all(result["rows_bitwise"].values())
    print(f"requests of {list(ROW_REQUESTS)} windows: {time.perf_counter() - t_rows:.1f} s")
    # Answers a caller holds, against later requests of their size: the caching
    # host allocator reuses a block only once its answer is dropped.
    windows = rng.random((13, B, cfg.nt_cond) + cfg.frame_shape, dtype=np.float32)
    held = [fc.predict(w) for w in windows[:3]]
    kept = [a.copy() for a in held]
    for w in windows[3:]:  # each answer dropped once the next is in hand: two blocks alternate
        last = fc.predict(w)
    unchanged = all(np.array_equal(a, k) for a, k in zip(held, kept))
    print(f"three {B}-window answers held across {len(windows) - 3} later {B}-window "
          f"requests: bitwise unchanged {unchanged}")
    check(unchanged, "a held answer changed under later requests")
    check(not any(np.array_equal(a, last) for a in held),
          "a later request gave a held answer's frames")
    del held, kept, last
    train_cfg = ExperimentConfig(data="mnist", architecture="dcgan", precision="f32",
                                 fused_loss=True, batch_size=TRAIN_CHECK_B)
    train_model = build_separable_network(train_cfg, dev, torch.Generator().manual_seed(0))
    opt = make_optimizer(train_model.parameters(), train_cfg, steps_per_epoch=100)
    state = TrainState(model=train_model, optimizer=opt, generator=torch.Generator())
    seq = torch.from_numpy(moving_squares(TRAIN_CHECK_B, train_cfg.nt_cond + train_cfg.nt_pred,
                                          seed=19)).to(dev)
    transposed_conv.launches = 0
    make_train_step(train_model, train_cfg, opt)(state, seq[:, :train_cfg.nt_cond],
                                                 seq[:, train_cfg.nt_cond:],
                                                 t_random=TRAIN_CHECK_T_RANDOM)
    torch.cuda.synchronize()
    result["launches_train_step"] = transposed_conv.launches
    print(f"transposed_conv launches in one f32 train step: {result['launches_train_step']}")
    check(result["launches_train_step"] == 0, "the train step launched the decoder kernel")
    del fc, model, train_model, state
    torch.cuda.empty_cache()
    gaps = serve_calibration_gaps()
    result["serve_frame_gaps"] = gaps
    print(f"serving cell frame_gap on seeds {list(SERVE_CALIBRATION_SEEDS)}: max "
          f"{max(gaps):.3e} (tolerance {DECODER_FRAME_GAP_TOL:g}; the cell's limit 5e-05): "
          + ", ".join(f"{g:.3e}" for g in gaps))
    check(max(gaps) <= DECODER_FRAME_GAP_TOL, "the serving cell's frame_gap")
    return result


def device_phase(ctx) -> None:
    """Phase 1: the card and the CUDA build of torch; TF32 is off (``main``)."""
    print(f"nvidia-smi: {ctx.smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {ctx.card}, "
          f"count {torch.cuda.device_count()}")
    print(f"TF32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def build_kernels(ctx) -> dict:
    """The product ``ctx.libs``: every ``csrc/*.cu`` built with nvcc.
    Returns name -> library."""
    t = time.perf_counter()
    libs = _build.build()
    print(f"build: {len(libs)} kernel(s) in {time.perf_counter() - t:.1f} s")
    return libs


def build_phase(ctx) -> None:
    """Phase 2: the build, with ptxas's report and whether it shows register
    spills."""
    for name, lib in ctx.libs.items():
        log = (lib.parent / "build.log").read_text().strip()
        print(f"  {name}: {lib}\n    " + log.replace("\n", "\n    "))
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
        print(f"  {name}: ptxas reports " + ("no register spills" if not spills else
                                             "register spills: " + "; ".join(spills)))


def seed0_model(ctx) -> types.SimpleNamespace:
    """The product ``ctx.seed0``: the full-width f32 flagship model built
    from seed 0 (``model``, ``cfg``), in eval mode, and its window: B 64
    windows drawn from seed 0 (``cond``, on the card ``cond_dev``), their
    T code ``t0`` and the integrator's ``params``."""
    cfg = ExperimentConfig(data="mnist", architecture="dcgan", precision="f32")
    model = build_separable_network(cfg, ctx.dev, torch.Generator().manual_seed(0)).eval()
    cond = np.random.default_rng(0).random((B, cfg.nt_cond) + cfg.frame_shape, dtype=np.float32)
    cond_dev = torch.from_numpy(cond).to(ctx.dev)
    with torch.inference_mode():
        t0 = model.encode_t(cond_dev).contiguous()
    return types.SimpleNamespace(model=model, cfg=cfg, cond=cond, cond_dev=cond_dev, t0=t0,
                                 params=model.t_resnet.flat_params())


def four_block_model(ctx) -> types.SimpleNamespace:
    """The product ``ctx.four_blocks``: the seed-0 flagship with a 4-block
    integrator (``model``, ``cfg``), which no resident cluster holds."""
    cfg = ExperimentConfig(data="mnist", architecture="dcgan", precision="f32", n_blocks=4)
    model = build_separable_network(cfg, ctx.dev, torch.Generator().manual_seed(0)).eval()
    return types.SimpleNamespace(model=model, cfg=cfg)


def kernel_cases(ctx) -> dict:
    """The product ``ctx.kernel_cases``: phase 3's cases, label -> (t0,
    params, n_steps, the plan's (variant, cluster or None[, resident]))."""
    dev, seed0 = ctx.dev, ctx.seed0
    gen = torch.Generator().manual_seed(1)
    ragged = MLPResnet(20, 2, 512, generator=gen).to(dev)
    cases = {
        "serving B64 code20 H512 1 block 100 steps": (
            seed0.t0, seed0.params, N_FORECAST, ("cluster", 8)),
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
            ("stream", None)),
    }
    # The WaveEq eval's rollout (a random 3-block integrator; 10f runs the
    # model's own), a ragged batch of it, and the kernels' 16-block limit,
    # 30 steps: at random init 16 blocks a step reach ~1e19 by then.
    wave_params = MLPResnet(32, 3, 512, generator=gen).to(dev).flat_params()
    cases.update({
        "wave B256 code32 H512 3 blocks 45 steps": (
            torch.randn(WAVE_EVAL_B, 32, generator=gen).to(dev), wave_params,
            WAVE_ROLLOUT_STEPS, ("stream", None)),
        "ragged wave B250 code32 H512 3 blocks 45 steps": (
            torch.randn(250, 32, generator=gen).to(dev), wave_params, WAVE_ROLLOUT_STEPS,
            ("stream", None)),
        "16 blocks B64 code20 H256 30 steps": (
            torch.randn(B, 20, generator=gen).to(dev),
            MLPResnet(20, 16, 256, generator=gen).to(dev).flat_params(), 30,
            ("stream", None)),
        # No cluster holds these blocks' W1 and W3 slices beside the ring: the
        # streaming kernel reads them from L2.
        "8 blocks B64 code64 H512 30 steps": (
            torch.randn(B, 64, generator=gen).to(dev),
            MLPResnet(64, 8, 512, generator=gen).to(dev).flat_params(), 30,
            ("stream", None, False)),
        "8 blocks B50 code20 H2048 20 steps": (
            torch.randn(50, 20, generator=gen).to(dev),
            MLPResnet(20, 8, 2048, generator=gen).to(dev).flat_params(), 20,
            ("stream", None, False)),
    })
    cases.update(chairs_kernel_cases(dev))
    return cases


def kernel_cases_phase(ctx) -> dict:
    """Phase 3: ``ctx.kernel_cases`` through the kernels against plain.
    Returns {(label, variant): (step-relative, abs)}."""
    errors = check_kernel_cases(ctx.kernel_cases)
    check({v for _, v in errors} == {"cluster", "stream"}, "both variants checked")
    return errors


def serving_phase(ctx) -> dict:
    """Phase 4: serving, the main path through the cluster kernel (a) and a
    4-block integrator through the streaming kernel (b).  Returns each
    kernel's launches on its path."""
    seed0, cfg, cond = ctx.seed0, ctx.seed0.cfg, ctx.seed0.cond
    fc = Forecaster(seed0.model, cfg, batch_size=B, n_forecast=N_FORECAST, device=ctx.dev)
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
        # Padded rows are held to the frame tolerance here and to bitwise
        # identity below with cudnn.deterministic (the f32 decoder runs the
        # port's own kernel, which uses no atomics; phase 19 holds it bitwise
        # with cuDNN's default algorithms too).
        check_frames(a, answers[B][:b], f"padded {b}-window answer vs the {B}-window rows")
    torch.backends.cudnn.deterministic = True
    exact = {b: fc.predict(cond[:b]) for b in REQUESTS[:2]}
    torch.backends.cudnn.deterministic = False
    small = REQUESTS[1]
    identical = np.array_equal(exact[small], exact[B][:small])
    print(f"with cudnn.deterministic: {small}-window answer bitwise equal to the "
          f"{B}-window rows: {identical}")
    check(identical, "padded rows differ with deterministic algorithms")
    model = seed0.model
    with torch.inference_mode():
        t_codes_kernel = model.get_forecast(seed0.cond_dev, N_FORECAST)[1].transpose(0, 1)
        t_codes_plain = mlp_resnet_rollout_reference(seed0.t0, seed0.params, N_FORECAST)
        frames_plain = model._decode_all(model.encode_s(seed0.cond_dev), None, t_codes_plain)
    rel = step_rel_err(t_codes_kernel, t_codes_plain)
    print(f"serving T codes vs plain rollout: step-relative {rel:.3e} "
          f"(tolerance {ROLLOUT_REL_TOL:g})")
    check(rel <= ROLLOUT_REL_TOL, "serving T codes disagree with the plain rollout")
    check_frames(answers[B], frames_plain.cpu().numpy(),
                 "forecast vs the plain-rollout forecast")

    # b. a 4-block integrator: the streaming kernel
    model4, cfg4 = ctx.four_blocks.model, ctx.four_blocks.cfg
    fc4 = Forecaster(model4, cfg4, batch_size=B, n_forecast=N_FORECAST, device=ctx.dev)
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
        t_codes4 = model4.get_forecast(seed0.cond_dev, N_FORECAST)[1].transpose(0, 1)
        t_codes4_plain = mlp_resnet_rollout_reference(
            model4.encode_t(seed0.cond_dev).contiguous(), model4.t_resnet.flat_params(),
            N_FORECAST)
    rel = step_rel_err(t_codes4, t_codes4_plain)
    print(f"4-block serving T codes vs plain rollout: step-relative {rel:.3e} "
          f"(tolerance {ROLLOUT_REL_TOL:g})")
    check(rel <= ROLLOUT_REL_TOL, "4-block serving T codes disagree with the plain rollout")
    return {"cluster": launches["cluster"], "stream": launches4["stream"]}


def kernel_timing_phase(ctx) -> dict:
    """Phase 5: the rollout kernels timed at the serving shapes, the
    streaming kernel at the 4-block serving shape and with W1, the biases
    and W3 from L2 (phase 3's 8-block case)."""
    seed0 = ctx.seed0
    code, hidden = seed0.t0.shape[1], seed0.params[0].shape[1]
    print(f"timing on {ctx.smi} (TF32 off); both kernels at the serving shapes, and the "
          f"cluster kernel at 4 rows a cluster:")
    serving = rollout_turns(ctx, seed0.t0, seed0.params, N_FORECAST, {
        "cluster": card_plan(B, code, hidden, 1),
        "stream": card_plan(B, code, hidden, 1, variant="stream"),
        "cluster at 4 rows": card_plan(B, code, hidden, 1, rows=4)})
    ms, rows4 = serving["ms"], serving["plans"]["cluster at 4 rows"]
    rows4_active = cluster_library().mlp_resnet_rollout_cluster_max_active(
        B, code, hidden, 1, rows4.cluster, rows4.rows)
    print(f"  the cluster kernel is {ms['stream'] / ms['cluster']:.2f}x as fast as the streaming "
          f"kernel; at 4 rows a cluster it needs {-(-B // rows4.rows)} clusters, at most "
          f"{rows4_active} at once, and takes {ms['cluster at 4 rows'] / ms['cluster']:.2f}x "
          f"its time at 8")
    model4 = ctx.four_blocks.model
    with torch.inference_mode():
        t0_4 = model4.encode_t(seed0.cond_dev).contiguous()
    params4 = model4.t_resnet.flat_params()
    t0_l2, params_l2, n_l2, _ = ctx.kernel_cases["8 blocks B64 code64 H512 30 steps"]
    plans = {"4-block serving": card_plan(B, code, hidden, 4),
             "8 blocks from L2": card_plan(B, t0_l2.shape[1], params_l2[0].shape[1], 8)}
    for label, plan in plans.items():
        check(plan.variant == "stream", f"the {label} plan {plan} is not the streaming kernel")
    print("the streaming kernel at the 4-block serving shape:")
    serving4 = rollout_turns(ctx, t0_4, params4, N_FORECAST,
                             {"stream": plans["4-block serving"]}, reps=3, inner=2)
    print("the streaming kernel with W1, the biases and W3 from L2:")
    from_l2 = rollout_turns(ctx, t0_l2, params_l2, n_l2, {"stream": plans["8 blocks from L2"]},
                            reps=3, inner=2)
    return {"serving": serving, "serving4": serving4, "from_l2": from_l2}


def check_kernel_cases(cases: dict) -> dict:
    """Phase 3: each case through the kernel its plan names (the serving,
    chairs and ragged-slice cases also through the streaming kernel,
    forced), against the plain version; for each plan, the kernel's own
    shared-memory layout against the plan's and the clusters that fit at
    once.  Returns {(label, variant): (step-relative, abs)}."""
    cluster_lib, stream_lib = cluster_library(), stream_library()
    errors = {}
    for label, (t0, params, n, expected) in cases.items():
        batch, code = t0.shape
        hidden, n_blocks = params[0].shape[1], len(params) // 6
        plans = [card_plan(batch, code, hidden, n_blocks)]
        # A streaming plan's cluster size follows the card's occupancy; its
        # weights other than W2 are resident unless the case says otherwise.
        variant, cluster, resident = expected + (True,) * (3 - len(expected))
        check((plans[0].variant, plans[0].cluster if cluster else None, plans[0].resident)
              == (variant, cluster, resident), f"plan {plans[0]} is not {expected} [{label}]")
        if label.startswith(("serving", "chairs", "ragged slice")):
            plans.append(card_plan(batch, code, hidden, n_blocks, variant="stream"))
        ref = mlp_resnet_rollout_reference(t0, params, n)
        for plan in plans:
            if plan.variant == "cluster":
                k_smem = cluster_lib.mlp_resnet_rollout_cluster_smem_bytes(
                    code, hidden, n_blocks, plan.cluster, plan.rows)
                active = cluster_lib.mlp_resnet_rollout_cluster_max_active(
                    batch, code, hidden, n_blocks, plan.cluster, plan.rows)
            else:
                k_smem = stream_lib.mlp_resnet_rollout_smem_bytes(
                    code, hidden, n_blocks, plan.cluster, plan.rows, int(plan.resident))
                active = stream_lib.mlp_resnet_rollout_max_active(
                    batch, code, hidden, n_blocks, plan.cluster, plan.rows,
                    int(plan.resident))
            print(f"plan [{label}]: {plan_text(plan)}, grid {plan.grid}; the kernel's own "
                  f"layout {k_smem} bytes; at most {active} such clusters at once")
            check(k_smem == plan.smem_bytes, "plan and kernel disagree on shared memory")
            check(active >= 1, f"no cluster of the plan fits [{label}]")
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
    return errors


# Each product a later phase reads: the one function that builds it.
PRODUCTS = {
    "libs": build_kernels,           # phase 2; 17 reads it
    "seed0": seed0_model,            # phase 3; 4, 5, 9, 15, 19
    "kernel_cases": kernel_cases,    # phase 3; 5
    "four_blocks": four_block_model,  # phase 4; 5
    "digits": write_digits,          # phase 8; 8b, 9, 14
    "checkpoint": train_cli,         # phase 8b; 8, 9, 14
    "test_set": write_test_set,      # phase 9; 9c, 15
    "eval_archive": eval_clis,       # phase 9c; 9, 14
    "small_wave": write_small_wave,  # phase 14a; 15f
    "corpora": taxibj_and_sst,       # phases 12-13; 18
}


class Context:
    """What the phases share: the card, its peaks, one working directory,
    and the products of ``PRODUCTS`` as attributes, each built at its first
    use and then kept."""

    def __init__(self, dev: torch.device, work: str):
        self.dev, self.work = dev, work
        self.smi = nvidia_smi()
        self.card = torch.cuda.get_device_name(dev)
        self.flops_peak, self.bw_peak = card_peaks(self.card)[:2]

    def __getattr__(self, name: str):
        if name not in PRODUCTS:
            raise AttributeError(name)
        product = PRODUCTS[name](self)
        setattr(self, name, product)
        return product


# The phases in the order a whole run takes them: (label, function of the context).
PHASES = [
    ("1", device_phase),
    ("2", build_phase),
    ("3", kernel_cases_phase),
    ("4", serving_phase),
    ("5", kernel_timing_phase),
    ("6", lambda ctx: train_step_card_vs_cpu(ctx.dev)),
    ("7", flagship_train),
    ("8", train_entry_point),
    ("9", evaluation),
    ("10", wave_phase),
    ("11", chairs_phase),
    ("12-13", lambda ctx: ctx.corpora),
    ("14", ops_phase),
    ("15", parallel_phase),
    ("16", measurement_programs),
    ("17", migrated_experiment),
    ("18", hdf5_phase),
    ("19", decoder_kernel_phase),
]


def selected_phases(args: list) -> list:
    """The labels ``args`` names, every phase's if none; an unknown label
    exits nonzero with the list of labels."""
    labels = [label for label, _ in PHASES]
    unknown = [a for a in args if a not in labels]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phase {' '.join(unknown)}; the phases are "
                         + " ".join(labels))
    return list(args) or labels


def run_phases(labels: list, ctx: Context) -> tuple:
    """Each phase of ``labels``, in the order of ``PHASES``.  Returns
    ({label: its result}, {label: its seconds})."""
    results, seconds = {}, {}
    for label, phase in PHASES:
        if label in labels:
            t = time.perf_counter()
            results[label] = phase(ctx)
            seconds[label] = round(time.perf_counter() - t, 1)
            print(f"phase {label}: {seconds[label]:.1f} s")
    return results, seconds


def kernels_line(r: dict) -> dict:
    """The line with one entry per kernel, from every phase's result
    (``r[label]``)."""
    errors, launched, timed, evals = r["3"], r["4"], r["5"], r["9"]
    wave, chairs = r["10"]["turns"], r["11"]["turns"]
    taxibj, sst = r["12-13"]["taxibj"], r["12-13"]["sst"]
    ops, par, programs, migrated, files, decoder = (r["14"], r["15"], r["16"], r["17"], r["18"],
                                                    r["19"])
    serving, serving4, from_l2, eval_b16 = (timed["serving"], timed["serving4"],
                                            timed["from_l2"], evals["turns"])
    chairs_labels = [label for label, _ in errors if label.startswith("chairs")]
    serving_case = "serving B64 code20 H512 1 block 100 steps"
    sources = {"cluster": "mlp_resnet_rollout_cluster.cu", "stream": "mlp_resnet_rollout.cu"}
    paths = {"cluster": "serving, 1-block integrator", "stream": "serving, 4-block integrator"}
    eval_launches = {v: {"Evaluator.score, f32 seed 0, B 16 (9b)":
                         evals["b16"]["launches"] if v == "cluster" else 0,
                         **{f"{k} evaluate(model_bundle=f32 seed 0) (9c)": n[v]
                            for k, n in evals["bundle"].items()},
                         "eval CLIs on the bf16 checkpoint (9c)": 0}
                     for v in ("cluster", "stream")}
    wave_keys = {"wave_shapes": wave["shapes"], "wave_plan": wave["plans"]["stream"]._asdict(),
                 "wave_ms": wave["ms"]["stream"], "wave_plain_ms": wave["ms"]["plain"],
                 "wave_addmm_loop_ms": wave["ms"]["addmm"], "wave_bound_ms": wave["bound_ms"],
                 "wave_bound_by": wave["bound_by"], "wave_max_step_rel_err": wave["rel"]["stream"],
                 "wave_max_abs_err": wave["abs"]["stream"],
                 "wave_block_step_us": wave["block_step_us"]["stream"]}
    stream_keys = {
        "serving4_shapes": serving4["shapes"],
        "serving4_plan": serving4["plans"]["stream"]._asdict(),
        "serving4_ms": serving4["ms"]["stream"], "serving4_plain_ms": serving4["ms"]["plain"],
        "serving4_addmm_loop_ms": serving4["ms"]["addmm"],
        "serving4_bound_ms": serving4["bound_ms"], "serving4_bound_by": serving4["bound_by"],
        "from_l2_shapes": from_l2["shapes"], "from_l2_plan": from_l2["plans"]["stream"]._asdict(),
        "from_l2_ms": from_l2["ms"]["stream"], "from_l2_plain_ms": from_l2["ms"]["plain"],
        "from_l2_addmm_loop_ms": from_l2["ms"]["addmm"],
        "from_l2_bound_ms": from_l2["bound_ms"], "from_l2_bound_by": from_l2["bound_by"]}
    kt = taxibj["turns"]
    taxibj_keys = {"taxibj_shapes": kt["shapes"], "taxibj_plan": kt["plans"]["cluster"]._asdict(),
                   "taxibj_ms": kt["ms"]["cluster"], "taxibj_stream_ms": kt["ms"]["stream"],
                   "taxibj_plain_ms": kt["ms"]["plain"],
                   "taxibj_addmm_loop_ms": kt["ms"]["addmm"],
                   "taxibj_bound_ms": kt["bound_ms"], "taxibj_bound_by": kt["bound_by"],
                   "taxibj_max_step_rel_err": kt["rel"]["cluster"],
                   "taxibj_max_abs_err": kt["abs"]["cluster"]}

    def chairs_keys(v: str) -> dict:
        rel = max([errors[label, v][0] for label in chairs_labels] + [chairs["rel"][v]])
        return {"launches_chairs": {
                    "chairs_swap evaluate(model_bundle=f32 seed 0), whole test split (11f)":
                        r["11"]["launches"][v],
                    "chairs_swap CLI on the bf16 checkpoint (11e)": 0,
                    "chairs training through the CLI, its resume and host path (11d)": 0,
                    "chairs train step, card against CPU (11b)": 0},
                "chairs_shapes": chairs["shapes"], "chairs_ms": chairs["ms"][v],
                "chairs_plain_ms": chairs["ms"]["plain"],
                "chairs_addmm_loop_ms": chairs["ms"]["addmm"],
                "chairs_bound_ms": chairs["bound_ms"], "chairs_bound_by": chairs["bound_by"],
                "chairs_max_step_rel_err": rel}

    return {"kernels": [{
        "name": f"mlp_resnet_rollout[{v}]",
        "route": "cuda",
        "source": f"spatiotemporal_variable_separation_tpu_torch/csrc/{sources[v]}",
        "replaces": "spatiotemporal_variable_separation_tpu/ops/pallas/rollout.py:91",
        "launches": launched[v],
        "launches_path": paths[v] + "; the eval paths in launches_eval",
        "launches_eval": eval_launches[v],
        "max_abs_err": errors[serving_case, v][1],
        "max_step_rel_err": errors[serving_case, v][0],
        "ms": serving["ms"][v],
        "plain_ms": serving["ms"]["plain"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": None,
        "addmm_loop_ms": serving["ms"]["addmm"],
        "shapes": serving["shapes"],
        "plan": serving["plans"][v]._asdict(),
        "eval_shapes": eval_b16["shapes"], "eval_plan": eval_b16["plans"][v]._asdict(),
        "eval_ms": eval_b16["ms"][v], "eval_plain_ms": eval_b16["ms"]["plain"],
        "eval_bound_ms": eval_b16["bound_ms"], "eval_bound_by": eval_b16["bound_by"],
        "launches_wave": {"wave evaluate(model_bundle=f32 seed 0), whole test split (10f)":
                          r["10"]["launches"][v],
                          "wave and wave_partial CLIs on the bf16 checkpoints (10e)": 0,
                          "wave and wave_partial training (10d)": 0},
        **(wave_keys if v == "stream" else {}),
        **(stream_keys if v == "stream" else {}),
        **chairs_keys(v),
        "launches_taxibj": {
            "taxibj evaluate(model_bundle=f32 seed 0), whole test split (12e)":
                taxibj["launches"][v],
            "taxibj on the bf16 checkpoint (12d)": 0,
            "taxibj training and its resume (12c)": 0,
            "taxibj train step, card against CPU (12a)": 0},
        **(taxibj_keys if v == "cluster" else {}),
        "launches_hdf5": {
            "test_taxibj CLI from the files, phase 12's experiment in f32 (18f)":
                files["evals"]["taxibj"]["launches"][v],
            "the same eval of the in-memory split (18f)":
                files["evals"]["taxibj"]["memory_launches"][v],
            "test_sst CLI from the files, phase 13's experiment (18f)":
                files["evals"]["sst"]["launches"][v],
            "taxibj train CLI from the files (18e)": files["train"]["launches"][v]},
        "launches_sst": {
            "sst evaluate(model_bundle=f32 seed 0), zones 17-20 (13e)": sst["launches"][v],
            "sst on the bf16 checkpoint (13d)": 0,
            "sst training and its resume (13c)": 0,
            "sst train step, card against CPU (13a)": 0},
        "launches_ops": {
            "diagnose --epoch all, f32 flagship checkpoints 1, 2, final (14b)":
                ops["flagship"][v],
            "diagnose --epoch all, f32 WaveEq --no_s checkpoints 1, final (14b)":
                ops["wave"][v],
            "diagnose --epoch all, phase 8's bf16 flagship checkpoints (14b)": ops["bf16"][v],
            "--monitor_stability probes, f32 flagship, one a checkpoint (14c)":
                ops["monitor"][v],
            "--no_s f32 eval forecast, B 128 x 45 (14a)": ops["no_s"][v],
            "--no_s training (14a)": ops["no_s_train"][v],
            "supervised training, its stop and resume, counted in the children (14d)":
                ops["supervised"][v]},
        "launches_parallel": {
            f"Evaluator over (cuda:0, cuda:0), B 16 and a ragged B {PAR_EVAL_RAGGED} (15d)":
                par["eval"] if v == "cluster" else 0,
            f"Forecaster over (cuda:0, cuda:0), B {B} x {N_FORECAST}, {len(REQUESTS)} "
            "requests (15e)": par["serve"] if v == "cluster" else 0,
            "test_wave --devices 1, the f32 seed-0 wave recipe (15f)":
                par["test_wave"] if v == "stream" else 0,
            "data and tensor parallel training, world-1 NCCL and two ranks over gloo "
            "(15a-c)": par["train"][v]},
        "launches_bench": {
            "bench: the bf16 flagship train step and the fused datagen step (16a)":
                programs["bench"][v],
            "tools.trace_flagship (16b)": programs["trace"][v],
            "tools.bench_horizon_remat, the t95 B 32 rows (16c)": programs["remat"][v],
            f"tools.bench_serving_rollout, B {B} x {N_FORECAST}: f32 and mixed serving, "
            "the kernels timed (16d)": programs["serving"][v]},
        "launches_import": {
            f"the migrated flagship (import_torch), Forecaster B {B} x {N_FORECAST}, "
            f"{len(REQUESTS)} requests (17c)": migrated["launches"][v],
            "import_torch, export_torch and the second import (17b, 17d)":
                migrated["converter_launches"][v]},
    } for v in ("cluster", "stream")] + [{
        "name": "transposed_conv",
        "route": "cuda",
        "source": "spatiotemporal_variable_separation_tpu_torch/csrc/transposed_conv.cu",
        "replaces": None,
        "launches": decoder["launches_request"],
        "launches_path": f"serving, one B {B} x {N_FORECAST} request (one decode fold)",
        "launches_train_step": decoder["launches_train_step"],
        "padded_bitwise": decoder["padded_bitwise"],
        "rows_bitwise": decoder["rows_bitwise"],
        "rows_launches": decoder["rows_launches"],
        "serve_frame_gaps": decoder["serve_frame_gaps"],
        **{f"{shape}_{k}": v for shape in DECODER_SHAPES for k, v in decoder[shape].items()},
    }]}


def main(argv=None) -> None:
    labels = selected_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    t_main = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        ctx = Context(torch.device("cuda:0"), work)
        results, seconds = run_phases(labels, ctx)
    print("phase seconds: " + ", ".join(f"{k} {v}" for k, v in seconds.items()))
    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s in all")
    print(f"nvidia-smi: {ctx.smi}")  # again, beside the result lines at the end of the output
    if len(results) == len(PHASES):
        print(json.dumps(kernels_line(results)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": ctx.card,
                                             "count": torch.cuda.device_count()},
                      "checks": checks_passed}))


if __name__ == "__main__":
    main()
