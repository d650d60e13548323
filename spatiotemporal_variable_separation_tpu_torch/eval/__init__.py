"""Evaluation protocols: the shared ``Evaluator`` and its host-side helpers
(``common``), Moving MNIST (``mnist``) and its content-swap protocol
(``mnist_swap``), and WaveEq / WaveEq-100 (``wave``)."""

from spatiotemporal_variable_separation_tpu_torch.eval.common import Evaluator  # noqa: F401
