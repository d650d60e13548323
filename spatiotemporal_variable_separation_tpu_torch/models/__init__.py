"""The forecaster's modules: layers, DCGAN and MLP encoders/decoders, the
ResNet-18 encoder, integrator, SeparableNetwork, and the factory's builders
(the JAX package's ``models/__init__.py`` names)."""

from spatiotemporal_variable_separation_tpu_torch.models.factory import (
    build_separable_network,
    get_decoder,
    get_encoder,
    get_integrator,
)
from spatiotemporal_variable_separation_tpu_torch.models.resnet18 import BasicBlock, ResNet18
from spatiotemporal_variable_separation_tpu_torch.models.separable import SeparableNetwork

__all__ = ["BasicBlock", "ResNet18", "SeparableNetwork", "build_separable_network",
           "get_decoder", "get_encoder", "get_integrator"]
