"""``--skipco`` with an encoder narrower than the decoder: the port against
the JAX package, on the CPU.

The skip maps the decoder concatenates are as wide as the *encoder*'s
stages.  flax sizes each concatenating conv from the tensor it receives
(JAX ``models/conv.py:151-156`` for DCGAN, ``:198-205`` for VGG); the port
takes the encoder's width (``skip_nf``) from the factory.  Cases at
``enc_hidden_size`` 8 and ``dec_hidden_size`` 16:

* the forecast, eval mode, with the same redrawn variables on both sides
  carried across by ``load_flax_variables``: atol 1e-5 (the same f32 math,
  sums in another order, as in ``test_torch_models``);
* one whole f32 train step (JAX ``make_train_step``, the port's with the
  JAX step's ``t_random`` injected): every loss term within 1e-4 relative.

The ``--skipco`` pairings the config accepts but the JAX package cannot run
(an encoder that returns no skip maps, or maps of other sizes) are refused
by the port's factory with a ``ConfigError`` that names the JAX line where
the JAX forward fails; the JAX side is shown failing there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu.train.state import TrainState as JaxTrainState
from spatiotemporal_variable_separation_tpu.train.step import (
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ConfigError, ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from test_torch_layers import ATOL, GEN, port, random_variables
from torch_threads import few_torch_threads  # noqa: F401

LOSS_RTOL = 1e-4
B, NT_COND, NT_PRED = 3, 2, 3
WIDTHS = dict(skipco=True, enc_hidden_size=8, dec_hidden_size=16, precision="f32",
              nt_cond=NT_COND, nt_pred=NT_PRED, offset=NT_COND, res_hidden_size=16,
              batch_size=B)
CASES = {  # the configurations the JAX package runs with unequal widths
    "mnist-dcgan": dict(data="mnist", code_size_s=12, code_size_t=8),
    "mnist-vgg64": dict(data="mnist", architecture="vgg", code_size_s=12, code_size_t=8),
    "taxibj-vgg32": dict(data="taxibj", architecture="vgg", code_size_s=12, code_size_t=8),
}
# (encoder, decoder, data): the JAX line where the forward fails
REFUSED = {
    ("dcgan", "vgg", "mnist"): "conv.py:199",
    ("vgg", "dcgan", "mnist"): "conv.py:152",
    ("mlp", "dcgan", "wave"): "separable.py:198",
    ("mlp", "vgg", "wave"): "separable.py:198",
    ("resnet", "vgg", "chairs"): "separable.py:198",
}


def _fields(case: str) -> dict:
    return {**WIDTHS, **CASES[case]}


def _sequence(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((B, NT_COND + NT_PRED) + cfg.frame_shape,
                                              dtype=np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_forecast_matches_jax_with_a_narrower_encoder(case):
    jcfg = JaxConfig(**_fields(case)).validate()
    jmodel = jax_build(jcfg)
    cond = _sequence(jcfg, 1)[:, :NT_COND]
    v = random_variables(jmodel, jnp.asarray(cond), 4, seed=2)
    ref = np.asarray(jmodel.apply(v, jnp.asarray(cond), 4, train=False,
                                  method=jmodel.get_forecast)[0])
    tmodel = port(build_separable_network(ExperimentConfig(**_fields(case)),
                                          torch.device("cpu"), GEN), v)
    with torch.no_grad():
        out = tmodel.get_forecast(torch.from_numpy(cond), 4)[0].numpy()
    assert out.shape == ref.shape == (B, 4) + jcfg.frame_shape
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_loss_matches_jax_with_a_narrower_encoder(case):
    jcfg = JaxConfig(**_fields(case)).validate()
    cfg = ExperimentConfig(**_fields(case))
    jmodel = jax_build(jcfg)
    seq = _sequence(jcfg, 3)
    cond, target = seq[:, :NT_COND], seq[:, NT_COND:]
    v = random_variables(jmodel, jnp.asarray(cond), 2, seed=5)
    tx = jax_make_optimizer(jcfg, 10)
    params = jax.tree.map(jnp.asarray, v["params"])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
                           opt_state=tx.init(params), rng=jax.random.PRNGKey(11))
    # the JAX step's own draw (train/step.py:89-93), injected into the port's
    t_random = int(jax.random.randint(jax.random.fold_in(jstate.rng, jstate.step), (),
                                      NT_COND, NT_COND + NT_PRED + 1, jnp.int32))
    _, jmetrics = jax_make_train_step(jmodel, jcfg, tx)(jstate, jnp.asarray(cond),
                                                       jnp.asarray(target))
    tmodel = build_separable_network(cfg, torch.device("cpu"), GEN)
    port(tmodel, v).train()
    opt = make_optimizer(tmodel.parameters(), cfg, 10)
    state = TrainState(model=tmodel, optimizer=opt, generator=torch.Generator())
    metrics = make_train_step(tmodel, cfg, opt)(state, torch.from_numpy(cond),
                                                torch.from_numpy(target), t_random=t_random)
    assert set(metrics) == set(jmetrics)
    for k, value in metrics.items():
        np.testing.assert_allclose(float(value), float(jmetrics[k]), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("enc,dec,data", list(REFUSED))
def test_skip_pairings_the_jax_forward_cannot_run_are_refused(enc, dec, data):
    fields = dict(data=data, architecture=enc, decoder_architecture=dec, skipco=True,
                  enc_hidden_size=8, dec_hidden_size=16, code_size_s=8, code_size_t=8,
                  res_hidden_size=16, enc_n_layers=2, dec_n_layers=2, nt_cond=2,
                  nt_pred=2, offset=2, precision="f32")
    line = REFUSED[enc, dec, data]
    with pytest.raises(ConfigError, match=line.replace(".", r"\.")):
        build_separable_network(ExperimentConfig(**fields), torch.device("cpu"), GEN)
    jcfg = JaxConfig(**fields).validate()  # the config accepts it
    jmodel = jax_build(jcfg)
    with pytest.raises((TypeError, IndexError, ValueError)):
        jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((3, 2) + jcfg.frame_shape), 2))
