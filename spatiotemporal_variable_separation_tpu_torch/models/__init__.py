"""The forecaster's modules: layers, DCGAN and MLP encoders/decoders, the
ResNet-18 encoder, integrator, SeparableNetwork."""

from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.models.resnet18 import BasicBlock, ResNet18

__all__ = ["BasicBlock", "ResNet18", "build_separable_network"]
