"""The port's kernel build cache (``utils/compile_cache.py``): how the root
is resolved, and that ``ops/_build.py`` builds into and loads from it.

Mirrors the JAX package's ``tests/test_compile_cache.py``: the environment
variable disables the shared cache, an explicit directory beats the
variable, and the default is the checkout's ``build/kernels/``.  The builds
run a stand-in ``nvcc`` (``test_torch_build``), so no toolkit is needed."""

import numpy as np
import pytest
import torch

from spatiotemporal_variable_separation_tpu_torch.ops import _build
from spatiotemporal_variable_separation_tpu_torch.utils import compile_cache
from spatiotemporal_variable_separation_tpu_torch.utils.compile_cache import (
    DEFAULT_ROOT,
    build_root,
    enable_compilation_cache,
)
from test_torch_build import _fake_nvcc


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    """Each test resolves the root anew, and leaves the process's as it was."""
    monkeypatch.setattr(compile_cache, "_root", None)
    monkeypatch.setattr(compile_cache, "_process_dir", None)
    monkeypatch.delenv(compile_cache.ENV, raising=False)


@pytest.mark.parametrize("value", ["0", "off", "OFF", "none", ""])
def test_env_disable(monkeypatch, value):
    monkeypatch.setenv("VARSEP_COMPILE_CACHE", value)
    assert enable_compilation_cache() is None
    root = build_root()
    assert root.is_dir() and root != DEFAULT_ROOT and root.name.startswith("varsep-kernels-")
    # one temporary directory for the process, whatever asks again
    assert enable_compilation_cache("/somewhere/explicit") is None
    assert build_root() == root


def test_explicit_dir_beats_env(monkeypatch, tmp_path):
    monkeypatch.setenv("VARSEP_COMPILE_CACHE", str(tmp_path / "envdir"))
    explicit = str(tmp_path / "explicit")
    assert enable_compilation_cache(explicit) == explicit
    assert build_root() == tmp_path / "explicit"
    assert enable_compilation_cache() == str(tmp_path / "envdir")


def test_default_is_the_checkouts_build_kernels():
    assert DEFAULT_ROOT.parts[-2:] == ("build", "kernels")
    assert (DEFAULT_ROOT.parent.parent / "spatiotemporal_variable_separation_tpu_torch").is_dir()
    assert enable_compilation_cache() == str(DEFAULT_ROOT)
    assert build_root() == DEFAULT_ROOT


def test_build_root_resolves_at_first_use(monkeypatch, tmp_path):
    monkeypatch.setenv("VARSEP_COMPILE_CACHE", str(tmp_path))
    assert build_root() == tmp_path


@pytest.mark.parametrize("env", ["dir", "off"])
def test_library_path_and_build_use_the_resolved_root(monkeypatch, tmp_path, env):
    log = _fake_nvcc(tmp_path, monkeypatch)
    monkeypatch.setenv("VARSEP_COMPILE_CACHE", str(tmp_path / "cache") if env == "dir" else "off")
    enable_compilation_cache()
    root = build_root()
    lib = _build.library_path("mlp_resnet_rollout")
    assert lib.parent.parent == root
    assert lib == _build.library_path("mlp_resnet_rollout", root)
    libs = _build.build(["mlp_resnet_rollout"])
    assert libs == {"mlp_resnet_rollout": lib} and lib.is_file()
    assert len(log.read_text().splitlines()) == 1
    # an explicit root still wins over the resolved one
    other = _build.build(["mlp_resnet_rollout"], build_root=tmp_path / "other")
    assert other["mlp_resnet_rollout"].parent.parent == tmp_path / "other"
    assert len(log.read_text().splitlines()) == 2
    # a finished build under the resolved root is reused: no third nvcc
    assert _build.build(["mlp_resnet_rollout"]) == libs
    assert len(log.read_text().splitlines()) == 2


def test_entry_points_keep_an_explicit_root(monkeypatch, tmp_path):
    """Building a ``Forecaster`` or an ``Evaluator`` leaves the root a caller
    set with ``enable_compilation_cache`` as it was: the kernels resolve it
    at their first build, not the entry points."""
    from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
    from spatiotemporal_variable_separation_tpu_torch.eval.common import Evaluator
    from spatiotemporal_variable_separation_tpu_torch.models.factory import (
        build_separable_network,
    )
    from spatiotemporal_variable_separation_tpu_torch.serve import Forecaster

    cfg = ExperimentConfig(data="wave", architecture="mlp", mixing="mul", code_size_s=4,
                           code_size_t=4, enc_hidden_size=8, dec_hidden_size=8,
                           res_hidden_size=8, enc_n_layers=2, dec_n_layers=2,
                           precision="f32")
    model = build_separable_network(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    monkeypatch.setenv("VARSEP_COMPILE_CACHE", str(tmp_path / "env"))
    assert enable_compilation_cache(str(tmp_path / "explicit")) == str(tmp_path / "explicit")
    Forecaster(model, cfg, 2, 3, device="cpu")
    Evaluator(model)
    assert build_root() == tmp_path / "explicit"
    out = Forecaster(model, cfg, 2, 3, device="cpu").predict(
        np.zeros((2, cfg.nt_cond) + cfg.frame_shape, np.float32))
    assert out.shape == (2, 3) + cfg.frame_shape
