"""PyTorch/CUDA port of the JAX package ``spatiotemporal_variable_separation_tpu``.

A second package beside the JAX one, held against it by the tests.  It
imports torch and numpy, never JAX nor the JAX package.  So far it trains
the DCGAN separable model on Moving MNIST made on the card
(``cli.main``, ``train.loop.run_training``, ``data.mnist_device``), with
checkpoints that resume bit-exactly (``checkpoint``), and serves the
``f32`` or ``mixed`` forecast of a checkpoint (``serve.Forecaster``), with
the MLP-ResNet rollout in hand-written CUDA kernels (``ops/rollout.py``:
``csrc/mlp_resnet_rollout_cluster.cu``, and ``csrc/mlp_resnet_rollout.cu``
for weights no thread-block cluster holds).
"""

from spatiotemporal_variable_separation_tpu_torch.core.config import ConfigError, ExperimentConfig

__all__ = ["ConfigError", "ExperimentConfig"]
