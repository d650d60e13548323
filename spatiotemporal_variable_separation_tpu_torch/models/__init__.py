"""The forecaster's modules: layers, DCGAN and MLP encoders/decoders, integrator,
SeparableNetwork."""

from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network

__all__ = ["build_separable_network"]
