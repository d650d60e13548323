"""PyTorch/CUDA port of the JAX package ``spatiotemporal_variable_separation_tpu``.

A second package beside the JAX one, held against it by the tests.  It
imports torch and numpy, never JAX nor the JAX package.  So far it trains
the DCGAN separable model on Moving MNIST made on the card
(``cli.main``, ``train.loop.run_training``, ``data.mnist_device``) and the
MLP model on WaveEq and WaveEq-100, simulated by RK4 on the card
(``cli.gen_wave``, ``cli.gen_pixels``, ``data.wave_eq``) and gathered there
(``data.wave_device``), and the ResNet-18 / DCGAN model on 3D Chairs renders
or their stand-in (``cli.gen_synthetic``, ``cli.gen_chairs``, ``data.chairs``,
``data.chairs_device``), with checkpoints that resume bit-exactly
(``checkpoint``); scores a checkpoint with both Moving MNIST protocols
(``eval``, ``cli.test_mnist``, ``cli.test_mnist_disentanglement``), the
WaveEq MSE at t+40 (``eval.wave``, ``cli.test_wave``) and the Chairs content
swap (``eval.chairs_swap``, ``cli.test_chairs_disentanglement``); and serves its
``f32``, ``mixed`` or ``bf16`` forecast (``serve.Forecaster``).  The f32 MLP-ResNet rollout runs
in hand-written CUDA kernels (``ops/rollout.py``:
``csrc/mlp_resnet_rollout_cluster.cu``, and ``csrc/mlp_resnet_rollout.cu``
for weights no thread-block cluster holds); a bf16 integrator is looped as
a module, as the JAX package scans it.
"""

from spatiotemporal_variable_separation_tpu_torch.core.config import ConfigError, ExperimentConfig

__all__ = ["ConfigError", "ExperimentConfig"]
