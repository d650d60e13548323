"""Evaluation protocols: the shared ``Evaluator`` and its host-side helpers
(``common``), Moving MNIST (``mnist``) and its content-swap protocol
(``mnist_swap``), WaveEq / WaveEq-100 (``wave``), the 3D Chairs
content-swap protocol (``chairs_swap``), TaxiBJ (``taxibj``), SST
(``sst``), and the rollout-stability probe (``diagnostics``)."""

from spatiotemporal_variable_separation_tpu_torch.eval.common import Evaluator  # noqa: F401
