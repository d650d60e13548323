"""Parameter counts of every model family: the port's ``sum(p.numel())``
equals the size of the JAX package's flax ``params`` tree.

``tests/test_param_parity.py`` holds the JAX package's modules to the
reference's torch modules; it needs the reference's code and skips without
it.  This holds the port to the JAX side, which is the side that was held
to the reference, so the chain closes without it.  The configurations are
the README recipes (``tests/test_recipes.py``) at their published widths,
and the integrators alone; counts are exact (no tolerance).  The flax side
is counted from ``jax.eval_shape`` (nothing is initialised).
"""

import math

import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models import integrator as jintegrator
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models import integrator as tintegrator
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from test_torch_layers import GEN
from torch_threads import few_torch_threads  # noqa: F401

MODELS = {  # family: config fields (the recipes of tests/test_recipes.py)
    "dcgan": dict(data="mnist"),
    "dcgan-skipco": dict(data="mnist", skipco=True),
    "vgg64": dict(data="mnist", architecture="vgg"),
    "vgg32": dict(data="taxibj", architecture="vgg", nt_cond=4, nt_pred=4, offset=4),
    "resnet": dict(data="chairs", architecture="resnet", decoder_architecture="dcgan",
                   code_size_t=10),
    "encoderSST-decoderSST": dict(data="sst", architecture="encoderSST",
                                  decoder_architecture="decoderSST", code_size_s=196,
                                  code_size_t=64, nt_cond=4, nt_pred=6, offset=0, n_blocks=2),
    "encoderSST-decoderSSTSkip": dict(data="sst", architecture="encoderSST",
                                      decoder_architecture="decoderSST", code_size_s=196,
                                      code_size_t=64, nt_cond=4, nt_pred=6, offset=0,
                                      n_blocks=2, skipco=True),
    "mlp": dict(data="wave", architecture="mlp", mixing="mul", code_size_s=32,
                code_size_t=32, n_blocks=3, enc_hidden_size=1200, dec_hidden_size=1200,
                dec_n_layers=4),
    "mlp-partial": dict(data="wave_partial", architecture="mlp", mixing="mul",
                        code_size_s=32, code_size_t=32, n_blocks=3, enc_hidden_size=2400,
                        dec_hidden_size=150),
    "no_s": dict(data="wave", architecture="mlp", no_s=True, code_size_t=32, n_blocks=3,
                 enc_hidden_size=1200, dec_hidden_size=1200, dec_n_layers=4),
}
# family: (JAX module, its input, port module) for the integrators alone
INTEGRATORS = {
    "MLPResnet": (lambda: jintegrator.MLPResnet(n_blocks=3, hidden_size=512),
                  jnp.ones((2, 32)), lambda: tintegrator.MLPResnet(32, 3, 512, generator=GEN)),
    "ConvResnet": (lambda: jintegrator.ConvResnet(n_blocks=2, nf=512),
                   jnp.ones((2, 16, 16, 64)),
                   lambda: tintegrator.ConvResnet(64, 2, 512, generator=GEN)),
}


def _flax_count(variables) -> int:
    return sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(variables["params"]))


def _jax_model_count(fields: dict) -> int:
    cfg = JaxConfig(**fields, precision="f32").validate()
    model = jax_build(cfg)
    cond = jnp.ones((1, cfg.nt_cond) + cfg.frame_shape)
    return _flax_count(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), cond, 2, train=False)))


@pytest.mark.parametrize("family", list(MODELS) + list(INTEGRATORS))
def test_param_count_matches_jax(family):
    if family in MODELS:
        expected = _jax_model_count(MODELS[family])
        cfg = ExperimentConfig(**MODELS[family], precision="f32")
        with torch.device("meta"):  # shapes only: no weights are drawn
            module = build_separable_network(cfg, torch.device("meta"), GEN)
    else:
        make_jax, x, make_port = INTEGRATORS[family]
        expected = _flax_count(jax.eval_shape(
            lambda: make_jax().init(jax.random.PRNGKey(0), x)))
        with torch.device("meta"):
            module = make_port()
    assert sum(p.numel() for p in module.parameters()) == expected
