"""The port's configuration, activations and initializers against the JAX
package's."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core import activations as jact
from spatiotemporal_variable_separation_tpu.core import config as jconfig
from spatiotemporal_variable_separation_tpu.core import inits as jinits
from spatiotemporal_variable_separation_tpu_torch.core import activations as tact
from spatiotemporal_variable_separation_tpu_torch.core import config as tconfig
from spatiotemporal_variable_separation_tpu_torch.core.inits import init_layer_


def test_config_fields_and_defaults_match():
    ours = {f.name: f for f in dataclasses.fields(tconfig.ExperimentConfig)}
    theirs = {f.name: f for f in dataclasses.fields(jconfig.ExperimentConfig)}
    assert list(ours) == list(theirs)
    assert tconfig.ExperimentConfig().to_json() == jconfig.ExperimentConfig().to_json()


@pytest.mark.parametrize("data", jconfig.DATASETS)
def test_config_derived_properties_match(data):
    kw = dict(data=data)
    ours, theirs = tconfig.ExperimentConfig(**kw), jconfig.ExperimentConfig(**kw)
    for prop in ("frame_shape", "channels", "last_activation", "decoder_arch",
                 "fully_conv_integrator", "effective_lamb_t", "average_tloss"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop


@pytest.mark.parametrize("overrides", [
    dict(data="nope"),
    dict(architecture="nope"),
    dict(mixing="mul", code_size_t=8, code_size_s=16),
    dict(data="taxibj"),  # dcgan needs 64x64 frames
    dict(offset=3),
    dict(fused_loss=True, decode_mode="batched"),
    dict(no_s=True, skipco=True),
    dict(precision="fp8"),
    dict(zone_size=32),
    dict(architecture="encoderSST", data="sst"),
    dict(data="wave_partial"),
])
def test_config_validation_errors_match(overrides):
    with pytest.raises(jconfig.ConfigError) as theirs:
        jconfig.ExperimentConfig(**overrides).validate()
    with pytest.raises(tconfig.ConfigError) as ours:
        tconfig.ExperimentConfig(**overrides).validate()
    assert str(ours.value) == str(theirs.value)


def test_config_reads_the_jax_packages_params_json(tmp_path):
    jcfg = jconfig.ExperimentConfig(code_size_t=24, skipco=True, precision="f32",
                                    zones=[1, 2])
    path = tmp_path / "params.json"
    jcfg.save(str(path))
    raw = json.loads(path.read_text())
    path.write_text(json.dumps({**raw, "torch_amp": True, "device": None}))
    ours = tconfig.ExperimentConfig.from_json_file(str(path))
    assert dataclasses.asdict(ours) == dataclasses.asdict(jcfg)
    assert ours.validate().skipco


@pytest.mark.parametrize("name", ["relu", "leaky_relu", "elu", "sigmoid", "tanh",
                                  "identity", None, "none"])
def test_activations_match(name):
    x = np.linspace(-4, 4, 33, dtype=np.float32)
    ref = np.asarray(jact.activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(tact.activation(name)(torch.from_numpy(x)).numpy(), ref,
                               atol=1e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="not implemented"):
        tact.activation("swish")


def _torch_layout(kind, k):
    """A flax kernel in the torch layout of ``kind``, flattened to 2-D the
    way torch's initializers see it."""
    k = np.asarray(k)
    if kind == "dense":
        return k.T
    if kind == "conv":  # (kh, kw, in, out) -> (out, in*kh*kw)
        return k.transpose(3, 2, 0, 1).reshape(k.shape[3], -1)
    return k.transpose(2, 3, 0, 1).reshape(k.shape[2], -1)  # convT: (in, out*kh*kw)


LAYERS = {  # torch layer, flax initializer factory, flax kernel shape
    "dense": (lambda: nn.Linear(96, 48), jinits.dense_kernel_init, (96, 48)),
    "conv": (lambda: nn.Conv2d(8, 24, 4), jinits.conv_kernel_init, (4, 4, 8, 24)),
    "convT": (lambda: nn.ConvTranspose2d(24, 6, 4), jinits.conv_transpose_kernel_init,
              (4, 4, 24, 6)),
}


@pytest.mark.parametrize("kind", list(LAYERS))
@pytest.mark.parametrize("init_type,gain", [("normal", 0.02), ("xavier", 0.5),
                                            ("kaiming", 1.0), ("orthogonal", 1.41)])
def test_inits_match_the_jax_distributions(kind, init_type, gain):
    make, jinit, shape = LAYERS[kind]
    layer = make()
    init_layer_(layer, init_type, gain, torch.Generator().manual_seed(0))
    ours = layer.weight.detach().reshape(layer.weight.shape[0], -1).numpy()
    theirs = _torch_layout(kind, jinit(init_type, gain)(jax.random.PRNGKey(0), shape))
    assert ours.shape == theirs.shape
    assert not layer.bias.detach().any()
    if init_type == "orthogonal":  # same orthogonalised orientation, same scale
        for w in (ours, theirs):
            small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
            np.testing.assert_allclose(small, gain ** 2 * np.eye(len(small)), atol=1e-4)
    else:  # same std (kaiming: ConvTranspose's output-channel fan included)
        assert abs(ours.mean()) < 0.1 * ours.std()
        np.testing.assert_allclose(ours.std(), theirs.std(), rtol=0.1)


def test_bn_init_and_generator_determinism():
    layers = [nn.BatchNorm2d(4096) for _ in range(3)]
    for layer, seed in zip(layers, (0, 0, 1)):
        init_layer_(layer, "normal", 0.02, torch.Generator().manual_seed(seed))
    w = layers[0].weight.detach().numpy()
    assert abs(w.mean() - 1.0) < 2e-3 and abs(w.std() - 0.02) < 2e-3
    assert not layers[0].bias.detach().any()
    assert torch.equal(layers[0].weight, layers[1].weight)
    assert not torch.equal(layers[0].weight, layers[2].weight)
