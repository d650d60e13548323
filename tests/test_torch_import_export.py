"""The port's reference-checkpoint converters (``utils/transplant.py``,
``utils/export.py``, ``cli/import_torch.py``, ``cli/export_torch.py``)
against the JAX package's, on the CPU, with stand-in reference experiments
(``test_torch_reference_standins``, which states the checks and their
tolerances): the MLP and DCGAN families and ``--no_s`` here, the ResNet-18,
VGG-32 and SST families in ``test_torch_import_export_resnet_vgg.py`` and
``test_torch_import_export_sst.py``.  Then the
refusals, the error that names a mismatched layer, the epoch snapshot, the
f32 pin and both CLIs.

At the end, the JAX package's own tests of its converters against the
reference's classes (``tests/test_import_torch.py``,
``tests/test_export_torch.py``) are mirrored for the port, under the same
skip: they run where the reference is mounted.
"""

import copy
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch import nn

from spatiotemporal_variable_separation_tpu_torch.checkpoint import load_for_eval, save_checkpoint
from spatiotemporal_variable_separation_tpu_torch.cli import export_torch as cli_export
from spatiotemporal_variable_separation_tpu_torch.cli import import_torch as cli_import
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.train.state import create_train_state
from spatiotemporal_variable_separation_tpu_torch.utils import export
from spatiotemporal_variable_separation_tpu_torch.utils.export import (
    export_reference_checkpoint,
    export_torch_module,
)
from spatiotemporal_variable_separation_tpu_torch.utils.transplant import (
    REFERENCE_FILES,
    import_reference_checkpoint,
    import_torch_module,
)
from spatiotemporal_variable_separation_tpu_torch.utils.weights import _torch_units
from test_import_torch import REFERENCE  # where the JAX package's own tests find it
from test_torch_layers import GEN
from test_torch_reference_standins import (
    FAMILIES,
    N_FORECAST,
    SMALL,
    assert_state_dicts_equal,
    check_export,
    check_forecast,
    check_import,
    cond_window,
    family_config,
    family_dirs,  # noqa: F401 (a fixture)
    jax_import,
    quiet,
    stand_in_modules,
    write_reference_xp,
)
from torch_threads import few_torch_threads  # noqa: F401

HERE = ["wave-mlp", "mnist-dcgan", "mnist-dcgan-skipco", "wave-no_s"]


@pytest.mark.parametrize("family", HERE)
def test_import_matches_the_jax_importer_bitwise(family, family_dirs):
    check_import(family_dirs(family))


@pytest.mark.parametrize("family", HERE)
def test_imported_forecasts_agree_with_jax(family, family_dirs):
    check_forecast(family_dirs(family))


@pytest.mark.parametrize("family", HERE)
def test_export_matches_the_jax_exporter_and_round_trips(family, family_dirs, monkeypatch):
    check_export(family_dirs(family), monkeypatch)


@pytest.mark.parametrize("arch,dec_arch", [("mlp", "mlp"), ("vgg", "mlp")])
def test_both_packages_reject_a_multichannel_mlp(tmp_path, arch, dec_arch):
    cfg = ExperimentConfig(data="taxibj", architecture=arch, decoder_architecture=dec_arch,
                           mixing="mul", code_size_s=8, code_size_t=8, enc_hidden_size=16,
                           dec_hidden_size=16, enc_n_layers=2, dec_n_layers=2,
                           **SMALL).validate()
    ref = tmp_path / "ref"
    ref.mkdir()
    cfg.save(str(ref / "params.json"))
    for run in (import_reference_checkpoint, jax_import):
        with pytest.raises(ValueError, match="channel-major"):
            run(str(ref), str(tmp_path / "out"), log_fn=quiet)
    # export: a port experiment of that config
    xp = tmp_path / "xp"
    xp.mkdir()
    cfg.save(str(xp / "params.json"))
    save_checkpoint(str(xp), create_train_state(cfg, 1, device="cpu"), name="final")
    with pytest.raises(ValueError, match="channel-major"):
        export_reference_checkpoint(str(xp), str(tmp_path / "ref_out"), log_fn=quiet)


def test_a_layer_count_or_shape_mismatch_names_the_layer(tmp_path):
    cfg = family_config(FAMILIES["mnist-dcgan"])
    modules = stand_in_modules(cfg, seed=3)
    port = build_separable_network(cfg, torch.device("cpu"), GEN).decoder
    short = nn.Sequential(*list(modules["decoder"].children())[:-1])
    for run in (import_torch_module, export_torch_module):
        with pytest.raises(ValueError, match=r"decoder: the reference module has \d+ "
                                             r"parameterized layers but the port's has"):
            run(short, port, "decoder")
    wide = copy.deepcopy(modules["decoder"])
    wide[1] = nn.BatchNorm2d(wide[1].num_features + 1)
    with pytest.raises(ValueError, match=r"decoder: reference '1' \(bn\) -> port "
                                         r"'first_upconv.bn'.*weight shape"):
        import_torch_module(wide, port, "decoder")
    with pytest.raises(ValueError, match=r"decoder: port 'first_upconv.bn' \(bn\) -> "
                                         r"reference '1'.*weight shape"):
        export_torch_module(wide, port, "decoder")
    swapped = copy.deepcopy(modules["decoder"])
    swapped[0] = nn.Conv2d(swapped[0].in_channels, swapped[0].out_channels, 4)
    with pytest.raises(ValueError, match="layer-kind mismatch"):
        import_torch_module(swapped, port, "decoder")
    # whole directories: both packages' importers name the module
    ref = write_reference_xp(tmp_path / "ref", cfg, {**modules, "decoder": short})
    with pytest.raises(ValueError, match="decoder: the reference module has"):
        import_reference_checkpoint(ref, str(tmp_path / "port"), log_fn=quiet)
    with pytest.raises(ValueError, match="decoder: torch module has"):
        jax_import(ref, str(tmp_path / "jax"), log_fn=quiet)


def test_epoch_snapshot_and_missing_file(tmp_path):
    cfg = family_config(FAMILIES["wave-mlp"])
    modules = stand_in_modules(cfg, seed=4)
    ref = write_reference_xp(tmp_path / "ref", cfg, modules, suffix="_40")
    for run in (import_reference_checkpoint, jax_import):
        with pytest.raises(FileNotFoundError, match="not a reference experiment"):
            run(ref, str(tmp_path / "out0"), log_fn=quiet)
    out = tmp_path / "out"
    path = import_reference_checkpoint(ref, str(out), epoch=40, log_fn=quiet)
    assert path == str(out / "checkpoints" / "40")
    model, _ = load_for_eval(str(out), name="40", device="cpu")
    assert torch.equal(_torch_units(model.Et)[0][2].weight, modules["Et"][0].weight)


def test_the_f32_pin_is_logged_and_kept_where_given(tmp_path):
    cfg = family_config(FAMILIES["wave-mlp"])
    ref = write_reference_xp(tmp_path / "ref", cfg, stand_in_modules(cfg, seed=5))
    logs = []
    import_reference_checkpoint(ref, str(tmp_path / "a"), log_fn=logs.append)
    assert any("pinning f32" in line for line in logs)
    assert load_for_eval(str(tmp_path / "a"), device="cpu")[1].precision == "f32"
    with open(os.path.join(ref, "params.json")) as f:
        params = json.load(f)
    params["precision"] = "mixed"  # a params.json of the port's own
    with open(os.path.join(ref, "params.json"), "w") as f:
        json.dump(params, f)
    logs.clear()
    import_reference_checkpoint(ref, str(tmp_path / "b"), log_fn=logs.append)
    assert not any("pinning" in line for line in logs)
    assert load_for_eval(str(tmp_path / "b"), device="cpu")[1].precision == "mixed"


def test_both_clis_end_to_end(tmp_path, monkeypatch, capsys):
    cfg = family_config(FAMILIES["wave-no_s"])
    modules = stand_in_modules(cfg, seed=6)
    ref = write_reference_xp(tmp_path / "ref", cfg, modules)
    xp = tmp_path / "xp"
    cli_import.main(["--ref_xp_dir", ref, "--xp_dir", str(xp)])
    assert (xp / "checkpoints" / "final" / "train_state.pt").is_file()
    assert json.load(open(xp / "params.json"))["no_s"] is True
    monkeypatch.setattr(export, "build_reference_modules",
                        lambda cfg, reference_root=None: stand_in_modules(cfg, seed=7))
    out = tmp_path / "ref_out"
    cli_export.main(["--xp_dir", str(xp), "--ref_xp_dir", str(out), "--name", "final"])
    assert all((out / f"{stem}.pt").is_file() for _, stem in REFERENCE_FILES)
    text = capsys.readouterr().out
    assert "imported Et" in text and "exported decoder" in text and "Es" not in text
    with pytest.raises(SystemExit):
        cli_import.main(["--xp_dir", str(xp)])  # --ref_xp_dir is required


# -- against the reference's own classes, where it is mounted ----------------------------
# The JAX package's tests/test_import_torch.py and tests/test_export_torch.py,
# for the port: the reference's factory builds the modules, the port imports
# them and its forward must reproduce theirs; an exported experiment must
# run in the reference's SeparableNetwork as it runs in the port.

needs_reference = pytest.mark.skipif(not os.path.isdir(REFERENCE),
                                     reason="reference not mounted")


def _ref_classes():
    if "torchvision" not in sys.modules:
        tv = types.ModuleType("torchvision")
        tv.datasets = types.SimpleNamespace(MNIST=None)
        sys.modules["torchvision"] = tv
    if REFERENCE not in sys.path:
        sys.path.insert(0, REFERENCE)
    from var_sep.networks.model import SeparableNetwork

    return SeparableNetwork


def _reference_forecast(modules: dict, cfg, cond: np.ndarray) -> np.ndarray:
    sep = _ref_classes()(modules["Es"], modules["Et"], modules["t_resnet"],
                         modules["decoder"], cfg.nt_cond, cfg.skipco).eval()
    with torch.no_grad():
        fc = sep.get_forecast(torch.from_numpy(np.moveaxis(cond, -1, 2).copy()),
                              N_FORECAST)[0]
    return np.moveaxis(fc.numpy(), 2, -1)


REFERENCE_FAMILIES = ["wave-mlp", "mnist-dcgan-skipco", "taxibj-vgg32", "wave-no_s"]


@needs_reference
@pytest.mark.parametrize("family", REFERENCE_FAMILIES)
def test_import_of_the_reference_classes_reproduces_their_forecast(family, tmp_path):
    cfg = family_config(FAMILIES[family])
    torch.manual_seed(0)
    modules = export.build_reference_modules(cfg, REFERENCE)
    rng = np.random.default_rng(0)
    for m in modules.values():
        for layer in m.modules():
            if isinstance(layer, (nn.BatchNorm1d, nn.BatchNorm2d)):
                n = layer.running_mean.numel()
                layer.running_mean.data = torch.tensor(rng.standard_normal(n) * 0.3,
                                                       dtype=torch.float32)
                layer.running_var.data = torch.tensor(rng.random(n) * 1.5 + 0.25,
                                                      dtype=torch.float32)
        m.eval()
    ref = write_reference_xp(tmp_path / "ref", cfg, modules)
    import_reference_checkpoint(ref, str(tmp_path / "xp"), reference_root=REFERENCE,
                                log_fn=quiet)
    model, _ = load_for_eval(str(tmp_path / "xp"), device="cpu")
    cond = cond_window(cfg, 2)
    with torch.no_grad():
        ours = model.get_forecast(torch.from_numpy(cond), N_FORECAST)[0].numpy()
    np.testing.assert_allclose(ours, _reference_forecast(modules, cfg, cond),
                               rtol=2e-4, atol=5e-4)


@needs_reference
@pytest.mark.parametrize("family", REFERENCE_FAMILIES)
def test_export_runs_in_the_reference_and_round_trips(family, tmp_path):
    cfg = family_config(FAMILIES[family])
    modules = stand_in_modules(cfg, seed=8)
    ref = write_reference_xp(tmp_path / "stand_in", cfg, modules)
    import_reference_checkpoint(ref, str(tmp_path / "xp"), log_fn=quiet)
    out = str(tmp_path / "ref_xp")
    export_reference_checkpoint(str(tmp_path / "xp"), out, reference_root=REFERENCE,
                                log_fn=quiet)
    exported = {key: torch.load(os.path.join(out, f"{stem}.pt"), weights_only=False)
                for key, stem in REFERENCE_FILES}
    model, _ = load_for_eval(str(tmp_path / "xp"), device="cpu")
    cond = cond_window(cfg, 3)
    with torch.no_grad():
        ours = model.get_forecast(torch.from_numpy(cond), N_FORECAST)[0].numpy()
    np.testing.assert_allclose(ours, _reference_forecast(exported, cfg, cond),
                               rtol=2e-4, atol=5e-4)
    import_reference_checkpoint(out, str(tmp_path / "back"), reference_root=REFERENCE,
                                log_fn=quiet)
    assert_state_dicts_equal(load_for_eval(str(tmp_path / "back"), device="cpu")[0]
                              .state_dict(), model.state_dict())
