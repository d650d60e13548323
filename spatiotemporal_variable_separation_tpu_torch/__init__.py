"""PyTorch/CUDA port of the JAX package ``spatiotemporal_variable_separation_tpu``.

A second package beside the JAX one, held against it by the tests.  It
imports torch and numpy, never JAX nor the JAX package, and does what the
JAX package does:

* **train** (``cli.main``, ``train``): the separable forecaster on Moving
  MNIST, WaveEq and WaveEq-100, 3D Chairs, TaxiBJ and SST, with batches made
  on the card (``data.*_device``) or on the host, checkpoints that resume
  bit-exactly (``checkpoint``), ``--no_s`` and ``--monitor_stability``;
  data-parallel over a process group (``--num_devices N``, one rank a device,
  global-batch BatchNorm) and tensor-parallel over a ``(data, model)`` mesh
  (``--model_parallel``, ``parallel``);
* **evaluate** all six protocols (``eval``, ``cli.test_*``), on one device or
  sharded over a mesh (``--devices N``);
* **serve** its ``f32``, ``mixed`` or ``bf16`` forecast (``serve.Forecaster``,
  also over a mesh);
* **generate data** (``cli.gen_wave``, ``cli.gen_pixels``,
  ``cli.gen_synthetic``, ``cli.make_mnist_test``) and run the operations
  tooling (``cli.diagnose``, ``cli.supervise``, ``cli.summarize``,
  ``cli.visualize``, ``cli.verify_corpus``).

The f32 MLP-ResNet rollout of eval, serving and the stability probe runs in
hand-written CUDA kernels (``ops/rollout.py``:
``csrc/mlp_resnet_rollout_cluster.cu``, and ``csrc/mlp_resnet_rollout.cu``
for weights no thread-block cluster holds), once a shard on a mesh; a bf16
integrator is looped as a module, as the JAX package scans it.
"""

from spatiotemporal_variable_separation_tpu_torch.core.config import ConfigError, ExperimentConfig

__all__ = ["ConfigError", "ExperimentConfig", "Forecaster"]


def __getattr__(name):  # lazy, as the JAX package's: serving pulls in checkpoints
    if name == "Forecaster":
        from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster

        return Forecaster
    raise AttributeError(name)
