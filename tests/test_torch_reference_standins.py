"""Stand-in reference experiments for the port's converter tests
(``tests/test_torch_import_export*.py``), and the checks each family goes
through against the JAX package's converters.

The reference's code is not here, so a family's reference experiment is a
stand-in built from a numpy seed: its four pickles are ``nn.Sequential``s of
plain ``torch.nn`` layers, one for each parameterized layer of the port's
module, in its registration order (a dead ``bn_out`` on the ResNet-18
encoders, as the reference has), with every weight and BatchNorm statistic
drawn at random; its ``params.json`` has no ``precision``, as the
reference's has none.  Both packages' importers read the same directory:

* ``check_import``: the JAX package's variables, carried into the port's
  model with ``load_flax_variables``, equal the port's imported weights and
  BatchNorm statistics bitwise (every layout change is a permutation), and
  both hold the stand-in's tensors;
* ``check_forecast``: the two imported experiments' eval forecasts agree
  within 1e-5 of the forecast's max |.| (the same f32 math, sums in
  another order; the random weights' frames reach O(10)-O(100));
* ``check_export``: both exporters, their reference factory replaced by
  fresh stand-ins, write pickles whose state dicts are equal bitwise and
  hold the imported tensors; the port's export followed by its import is
  the identity.

The JAX package's importer builds its model with an eager ``model.init``,
one XLA compile an op: 8-40 s a family on the CPU, most of each family's
time, so the families are split over three test files.  This module holds
no test of its own.
"""

import collections
import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu.checkpoint import load_for_eval as jax_load_for_eval
from spatiotemporal_variable_separation_tpu.utils import export as jax_export
from spatiotemporal_variable_separation_tpu.utils.transplant import (
    import_reference_checkpoint as jax_import,
)
from spatiotemporal_variable_separation_tpu_torch.checkpoint import load_for_eval
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.utils import export
from spatiotemporal_variable_separation_tpu_torch.utils.export import export_reference_checkpoint
from spatiotemporal_variable_separation_tpu_torch.utils.transplant import (
    REFERENCE_FILES,
    import_reference_checkpoint,
    unit_tensors,
)
from spatiotemporal_variable_separation_tpu_torch.utils.weights import (
    _torch_units,
    load_flax_variables,
)
from test_torch_layers import GEN

FORECAST_REL_TOL = 1e-5
N_FORECAST = 4
SMALL = dict(res_hidden_size=16, nt_cond=2, nt_pred=2, offset=2)
MLP = dict(data="wave", architecture="mlp", mixing="mul", code_size_s=8, code_size_t=8,
           enc_hidden_size=24, dec_hidden_size=24, enc_n_layers=2, dec_n_layers=2)
FAMILIES = {
    "wave-mlp": dict(MLP, n_blocks=2),
    "mnist-dcgan": dict(data="mnist", code_size_s=12, code_size_t=8, enc_hidden_size=8,
                        dec_hidden_size=8),
    "mnist-dcgan-skipco": dict(data="mnist", mixing="mul", code_size_s=12, code_size_t=12,
                               enc_hidden_size=8, dec_hidden_size=8, skipco=True),
    "chairs-resnet": dict(data="chairs", architecture="resnet", decoder_architecture="dcgan",
                          code_size_s=10, code_size_t=6, dec_hidden_size=8),
    "taxibj-vgg32": dict(data="taxibj", architecture="vgg", code_size_s=10, code_size_t=6,
                         enc_hidden_size=8, dec_hidden_size=8),
    "sst-convresnet": dict(data="sst", architecture="encoderSST",
                           decoder_architecture="decoderSST", code_size_s=6, code_size_t=4,
                           res_hidden_size=8, n_blocks=2, offset=0, skipco=True,
                           zone_size=16),
    "wave-no_s": dict(MLP, no_s=True),
}


def family_config(fields: dict) -> ExperimentConfig:
    return ExperimentConfig(**{**SMALL, **fields, "precision": "f32"}).validate()


def _draw(layer: nn.Module, kind: str, rng: np.random.Generator) -> None:
    """Every tensor of a stand-in layer, from ``rng``: kernels of unit-variance
    activations, BatchNorm statistics in the JAX package's ranges
    (``tests/test_import_torch.py:43-51``)."""
    w = layer.weight
    if kind == "bn":
        n = w.shape[0]
        values = {"weight": 1.0 + 0.2 * rng.standard_normal(n),
                  "bias": 0.1 * rng.standard_normal(n),
                  "running_mean": 0.3 * rng.standard_normal(n),
                  "running_var": rng.random(n) * 1.5 + 0.25}
    else:
        fan_in = w[:, 0].numel() if kind == "convT" else w[0].numel()
        values = {"weight": rng.standard_normal(tuple(w.shape)) / np.sqrt(fan_in),
                  "bias": 0.1 * rng.standard_normal(tuple(layer.bias.shape))}
    for key, value in values.items():
        getattr(layer, key).data = torch.tensor(value, dtype=torch.float32)


def stand_in(port_module: nn.Module, rng: np.random.Generator, dead_bn_out: bool) -> nn.Module:
    """A reference module of plain ``torch.nn`` layers with the port
    module's kinds and shapes, in its order, drawn from ``rng``."""
    layers = collections.OrderedDict()
    for i, (_, kind, m) in enumerate(_torch_units(port_module)):
        if kind == "dense":
            layer = nn.Linear(m.in_features, m.out_features)
        elif kind == "bn":
            layer = nn.BatchNorm2d(m.num_features)
        else:
            cls = nn.Conv2d if kind == "conv" else nn.ConvTranspose2d
            layer = cls(m.in_channels, m.out_channels, m.kernel_size, m.stride, m.padding)
        _draw(layer, kind, rng)
        layers[str(i)] = layer
    if dead_bn_out:  # defined by the reference's ResNet18, never applied
        layers["bn_out"] = nn.BatchNorm2d(layers[str(len(layers) - 1)].out_channels)
    return nn.Sequential(layers).eval()


def stand_in_modules(cfg: ExperimentConfig, seed: int) -> dict:
    model = build_separable_network(cfg, torch.device("cpu"), GEN)
    rng = np.random.default_rng(seed)
    return {key: stand_in(getattr(model, key), rng,
                          dead_bn_out=key in ("Es", "Et") and cfg.architecture == "resnet")
            for key, _ in REFERENCE_FILES}


def write_reference_xp(path, cfg: ExperimentConfig, modules: dict, suffix: str = "") -> str:
    """A reference experiment directory: its ``params.json`` has no precision."""
    os.makedirs(path, exist_ok=True)
    params = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "precision"}
    with open(os.path.join(path, "params.json"), "w") as f:
        json.dump(params, f)
    for key, stem in REFERENCE_FILES:
        torch.save(modules[key], os.path.join(path, f"{stem}{suffix}.pt"))
    return str(path)


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    """family -> its stand-in reference dir and both packages' imports,
    made once for the module's tests."""
    cache = {}

    def get(family: str) -> dict:
        if family not in cache:
            root = tmp_path_factory.mktemp(family)
            cfg = family_config(FAMILIES[family])
            modules = stand_in_modules(cfg, seed=list(FAMILIES).index(family))
            ref = write_reference_xp(root / "ref", cfg, modules)
            import_reference_checkpoint(ref, str(root / "port"), log_fn=quiet)
            jax_import(ref, str(root / "jax"), log_fn=quiet)
            cache[family] = dict(root=root, cfg=cfg, modules=modules, ref=ref,
                                 port=str(root / "port"), jax=str(root / "jax"))
        return cache[family]

    return get


def _jax_as_port(jax_dir: str):
    """The JAX package's imported experiment, carried into a port model."""
    jmodel, variables, jcfg = jax_load_for_eval(jax_dir)
    cfg = ExperimentConfig.from_json_file(os.path.join(jax_dir, "params.json"))
    model = build_separable_network(cfg, torch.device("cpu"), GEN)
    load_flax_variables(model, variables["params"], variables.get("batch_stats"))
    return model.eval(), (jmodel, variables, jcfg)


def assert_state_dicts_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def cond_window(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((2, cfg.nt_cond) + cfg.frame_shape,
                                              dtype=np.float32)


def check_import(d: dict) -> None:
    model, cfg = load_for_eval(d["port"], device="cpu")
    assert cfg.precision == "f32"  # pinned: the reference's params.json has none
    jax_model, _ = _jax_as_port(d["jax"])
    assert_state_dicts_equal(model.state_dict(), jax_model.state_dict())
    # and both hold the stand-in's tensors
    for key, _ in REFERENCE_FILES:
        ref, ours = unit_tensors(d["modules"][key]), unit_tensors(getattr(model, key))
        assert len(ref) == len(ours)
        assert all(torch.equal(r, o) for r, o in zip(ref, ours)), key


def check_forecast(d: dict) -> None:
    model, cfg = load_for_eval(d["port"], device="cpu")
    jmodel, variables, _ = jax_load_for_eval(d["jax"])
    cond = cond_window(cfg, 1)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(cond), N_FORECAST, train=False,
                                  method=jmodel.get_forecast)[0])
    with torch.no_grad():
        out = model.get_forecast(torch.from_numpy(cond), N_FORECAST)[0].numpy()
    assert out.shape == ref.shape == (2, N_FORECAST) + cfg.frame_shape
    assert np.isfinite(out).all()
    err = float(np.abs(out - ref).max() / np.abs(ref).max())
    assert err <= FORECAST_REL_TOL, err


def _export_both(d: dict, monkeypatch) -> tuple:
    """Both exporters over the two imports, their reference factory
    replaced by copies of the stand-in modules (fresh draws, so nothing of
    the import survives in them); the pickles each wrote."""
    fresh = stand_in_modules(d["cfg"], seed=99)
    builder = lambda cfg, reference_root=None: copy.deepcopy(fresh)  # noqa: E731
    monkeypatch.setattr(export, "build_reference_modules", builder)
    monkeypatch.setattr(jax_export, "build_reference_modules", builder)
    out = {}
    for side, run, src in (("port", export_reference_checkpoint, d["port"]),
                           ("jax", jax_export.export_reference_checkpoint, d["jax"])):
        dst = str(d["root"] / f"export_{side}")
        run(src, dst, log_fn=quiet)
        out[side] = {key: torch.load(os.path.join(dst, f"{stem}.pt"), weights_only=False)
                     for key, stem in REFERENCE_FILES}
        out[side + "_dir"] = dst
    return out


def check_export(d: dict, monkeypatch) -> None:
    out = _export_both(d, monkeypatch)
    for key, _ in REFERENCE_FILES:
        assert not out["port"][key].training
        assert_state_dicts_equal(out["port"][key].state_dict(), out["jax"][key].state_dict())
        # the exported tensors are the stand-in's, the dead bn_out left alone
        assert_state_dicts_equal(
            {k: v for k, v in out["port"][key].state_dict().items() if "bn_out" not in k},
            {k: v for k, v in d["modules"][key].state_dict().items() if "bn_out" not in k})
    with open(os.path.join(out["port_dir"], "params.json")) as f:
        assert json.load(f)["data"] == d["cfg"].data
    back = str(d["root"] / "reimported")
    import_reference_checkpoint(out["port_dir"], back, log_fn=quiet)
    assert_state_dicts_equal(load_for_eval(back, device="cpu")[0].state_dict(),
                              load_for_eval(d["port"], device="cpu")[0].state_dict())


