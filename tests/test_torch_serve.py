"""The port's serving path as a whole: ``Forecaster`` against the JAX
package's, from the same variables, f32 on the CPU; the no-fallback rule;
and the import rule (the port imports neither JAX nor the JAX package).

Tolerance: atol 2e-5 on the sigmoid outputs.  Each frame passes through two
encoders, a 5-step rollout and a 5-layer decoder, every one summing in f32
in another order on the two sides; the sigmoid's slope is at most 1/4, and
the rollout grows T by up to ~1.3x a step at this init, so the per-layer
1e-5 budget compounds to a little over it.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spatiotemporal_variable_separation_tpu import serve as jserve
from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu_torch import serve as tserve
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from test_torch_layers import random_variables

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spatiotemporal_variable_separation_tpu_torch"
ATOL = 2e-5
B, N = 4, 12
SMALL = dict(data="mnist", architecture="dcgan", precision="f32", nt_cond=5,
             code_size_s=16, code_size_t=8, enc_hidden_size=8, dec_hidden_size=8,
             res_hidden_size=32)


@pytest.mark.parametrize("skipco", [False, True])
def test_forecaster_matches_jax(skipco):
    kw = dict(SMALL, skipco=skipco)
    jcfg = JaxConfig(**kw)
    model = jax_build(jcfg)
    cond = np.random.default_rng(0).random((B, 5, 64, 64, 1), dtype=np.float32)
    variables = random_variables(model, jnp.asarray(cond), N, seed=1)
    ref = jserve.Forecaster(model, jax.tree.map(jnp.asarray, variables), jcfg, B, N)
    ours = tserve.Forecaster.from_flax_variables(ExperimentConfig(**kw), variables,
                                                 B, N, device="cpu")
    full = ours.predict(cond)
    assert full.shape == (B, N, 64, 64, 1)
    np.testing.assert_allclose(full, ref.predict(cond), atol=ATOL)
    # A 3-window request goes through the pad path; rows do not interact.
    part = ours.predict(cond[:3])
    assert part.shape == (3, N, 64, 64, 1)
    np.testing.assert_allclose(part, ref.predict(cond[:3]), atol=ATOL)
    np.testing.assert_allclose(part, full[:3], atol=1e-6)
    with pytest.raises(ValueError, match="exceeds"):
        ours.predict(np.concatenate([cond, cond[:1]]))


def test_mixed_forecaster_matches_jax():
    """``mixed``: encoders and decoder in bf16, the T code cast to f32 for the
    rollout (the kernel on the card, its plain version here), against the
    JAX package's ``mixed`` Forecaster.  Both round the convolutions in
    bf16 at other places, and the frames come out in bf16, whose ulp near 1
    is 3.9e-3: measured mean abs difference 7.4e-4, max 3.9e-3; held to 3e-3
    and 2e-2."""
    kw = dict(SMALL, precision="mixed")
    jcfg = JaxConfig(**kw)
    model = jax_build(jcfg)
    cond = np.random.default_rng(2).random((B, 5, 64, 64, 1), dtype=np.float32)
    variables = random_variables(model, jnp.asarray(cond), N, seed=3)
    ref = jserve.Forecaster(model, jax.tree.map(jnp.asarray, variables), jcfg, B, N).predict(cond)
    ours = tserve.Forecaster.from_flax_variables(ExperimentConfig(**kw), variables, B, N,
                                                 device="cpu")
    assert ours.model.Es.dtype == torch.bfloat16 and ours.model.t_resnet.dtype == torch.float32
    out = ours.predict(cond)
    assert out.dtype == np.float32 and out.shape == ref.shape == (B, N, 64, 64, 1)
    diff = np.abs(out - np.asarray(ref, np.float32))
    assert diff.mean() <= 3e-3 and diff.max() <= 2e-2, (diff.mean(), diff.max())


def test_forecaster_benchmark_reports_latency():
    cfg = ExperimentConfig(**SMALL)
    jmodel = jax_build(JaxConfig(**SMALL))
    variables = random_variables(jmodel, jnp.zeros((1, 5, 64, 64, 1)), 3)
    fc = tserve.Forecaster.from_flax_variables(cfg, variables, 2, 3, device="cpu")
    stats = fc.benchmark(n_iters=3, warmup=1)
    assert stats["device"] == "cpu" and stats["batch"] == 2 and stats["n_forecast"] == 3
    assert 0 < stats["p50_ms"] <= stats["p99_ms"]
    assert stats["frames_per_sec"] > 0


def test_forecaster_without_a_card_raises(monkeypatch, tmp_path):
    """``device=None`` means the card; without one there is no quiet CPU path.
    ``from_xp_dir`` reads the port's checkpoints (``tests/test_torch_checkpoint.py``);
    a directory without them raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jmodel = jax_build(JaxConfig(**SMALL))
    variables = random_variables(jmodel, jnp.zeros((1, 5, 64, 64, 1)), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.Forecaster.from_flax_variables(ExperimentConfig(**SMALL), variables, 2, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.Forecaster.from_xp_dir(str(tmp_path), 2, 3)
    with pytest.raises(FileNotFoundError):
        tserve.Forecaster.from_xp_dir(str(tmp_path), 2, 3, device="cpu")


def _port_modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
                  for p in PORT.rglob("*.py"))


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest), importing
    every module of the port loads neither JAX nor the JAX package."""
    mods = _port_modules()
    assert "spatiotemporal_variable_separation_tpu_torch.ops.rollout" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
            "'spatiotemporal_variable_separation_tpu'))\n"
            "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout, res.stdout


FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b"
    r"|\bspatiotemporal_variable_separation_tpu\."
    r"|^\s*(import|from)\s+spatiotemporal_variable_separation_tpu\b",
    re.MULTILINE)


def test_port_sources_name_no_jax():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted(ROOT.glob("tools/torch_*.py")))
    assert len(files) > 10
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits
