"""Both Moving MNIST protocols of the port (``eval/mnist.py``,
``eval/mnist_swap.py``) against the JAX package's, on one data directory of
synthetic digits (the fixture of ``tests/test_checkpoint_eval.py:233-260``),
with the same carried weights, on the CPU; resume and ``archive_cap``.

Tolerances: per-sequence MSE rtol 1e-5, PSNR atol 1e-4, SSIM atol 1e-4,
as ``tests/test_torch_eval.py`` (f32; the frames agree to ~1e-7).  The
uint8 archives truncate ``255 x`` frames, so a frame value within ~1e-7 of
a multiple of 1/255 may land on either side: pixels may differ by 1, on at
most 1e-3 of them (measured here: 4.1e-6 of the predictions' pixels, none
of the content swaps'); inputs and ground truth, which both packages build
with the same numpy code, are byte-equal.  Measured per-sequence
differences: MSE 2.3e-7 relative, PSNR 1.4e-6, SSIM 8.4e-7.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import write_idx_images, write_idx_labels
from spatiotemporal_variable_separation_tpu.core.config import ExperimentConfig as JaxConfig
from spatiotemporal_variable_separation_tpu.data.moving_mnist import load_mnist
from spatiotemporal_variable_separation_tpu.eval import mnist as jmnist
from spatiotemporal_variable_separation_tpu.eval import mnist_swap as jswap
from spatiotemporal_variable_separation_tpu.models.factory import (
    build_separable_network as jax_build,
)
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import (
    make_test_set,
    synthetic_digits,
)
from spatiotemporal_variable_separation_tpu_torch.eval import common as tcommon
from spatiotemporal_variable_separation_tpu_torch.eval import mnist as tmnist
from spatiotemporal_variable_separation_tpu_torch.eval import mnist_swap as tswap
from spatiotemporal_variable_separation_tpu_torch.models.factory import build_separable_network
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import make_mesh
from test_torch_layers import port, random_variables
from torch_threads import few_torch_threads  # noqa: F401

CFG = dict(data="mnist", architecture="dcgan", code_size_s=16, code_size_t=8,
           enc_hidden_size=4, dec_hidden_size=4, res_hidden_size=8, n_blocks=1,
           nt_cond=3, nt_pred=3, offset=3, precision="f32", batch_size=4)
RESULT_TOL = dict(mse=("rtol", 1e-5), psnr=("atol", 1e-4), ssim=("atol", 1e-4))
OFF_BY_ONE_SHARE = 1e-3


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """64 synthetic training digits, 32 test digits and a test set of 16
    sequences of 8 frames."""
    d = tmp_path_factory.mktemp("data")
    digits = synthetic_digits(64)
    labels = (np.arange(64) % 10).astype(np.uint8)
    write_idx_images(d / "train-images-idx3-ubyte", digits)
    write_idx_labels(d / "train-labels-idx1-ubyte", labels)
    write_idx_images(d / "t10k-images-idx3-ubyte", digits[:32])
    write_idx_labels(d / "t10k-labels-idx1-ubyte", labels[:32])
    make_test_set(str(d), seq_len=8, seed=42, digits=2)
    return str(d)


@pytest.fixture(scope="module")
def bundles():
    """The JAX ``(model, variables, cfg)`` and the port's ``(model, cfg)``,
    one set of seeded weights."""
    jcfg = JaxConfig(**CFG)
    jmodel = jax_build(jcfg)
    v = random_variables(jmodel, jnp.ones((2, 3, 64, 64, 1)), 2, seed=3)
    cfg = ExperimentConfig(**CFG)
    tmodel = port(build_separable_network(cfg, torch.device("cpu"),
                                          torch.Generator().manual_seed(0)), v)
    return (jmodel, jax.tree.map(jnp.asarray, v), jcfg), (tmodel, cfg)


def _xp(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    return str(d)


def _assert_results(ours_path, ref_path):
    with np.load(ours_path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files) == ["mse", "psnr", "ssim"]
        for k, (kind, tol) in RESULT_TOL.items():
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype == np.float64, k
            np.testing.assert_allclose(a[k], b[k], **{kind: tol}, err_msg=k)


def _assert_archives(ours_dir, ref_dir, layout, exact):
    for key, fname in layout:
        with np.load(os.path.join(ours_dir, fname)) as a, \
                np.load(os.path.join(ref_dir, fname)) as b:
            assert a.files == b.files == [key]
            x, y = a[key], b[key]
            assert x.dtype == y.dtype == np.uint8 and x.shape == y.shape, key
            if key in exact:
                assert x.tobytes() == y.tobytes(), key
            else:
                diff = np.abs(x.astype(np.int16) - y.astype(np.int16))
                assert diff.max() <= 1 and (diff > 0).mean() <= OFF_BY_ONE_SHARE, key


def test_mnist_protocol_matches_jax(tmp_path, data_dir, bundles):
    jb, tb = bundles
    ours_dir, ref_dir = _xp(tmp_path, "port"), _xp(tmp_path, "jax")
    kw = dict(nt_pred=5, batch_size=6, max_batches=2)
    ref = jmnist.evaluate(ref_dir, data_dir, model_bundle=jb, **kw)
    ours = tmnist.evaluate(ours_dir, data_dir, model_bundle=tb, **kw)
    assert set(ours) == set(ref) == {"mse", "psnr", "ssim"}
    assert 0 < ours["mse"] < 1 and 0 < ours["ssim"] <= 1
    _assert_results(os.path.join(ours_dir, "results.npz"), os.path.join(ref_dir, "results.npz"))
    with np.load(os.path.join(ours_dir, "results.npz")) as z:
        assert z["mse"].shape == (12,)
        assert ours["mse"] == float(z["mse"].mean())
    assert sorted(os.listdir(ours_dir)) == sorted(os.listdir(ref_dir))
    _assert_archives(ours_dir, ref_dir, tmnist.ARCHIVES,
                     exact={"gt", "cond", "cond_swap", "target_swap"})
    with np.load(os.path.join(ours_dir, "content_swap.npz")) as z:
        assert z["content_swap"].shape == (12, 5, 64, 64, 1)


def test_mnist_swap_protocol_matches_jax(tmp_path, data_dir, bundles):
    jb, tb = bundles
    ours_dir, ref_dir = _xp(tmp_path, "port"), _xp(tmp_path, "jax")
    images, _ = load_mnist(data_dir, train=False)
    kw = dict(nt_pred=5, batch_size=4, max_batches=2, images=images)
    ref = jswap.evaluate(ref_dir, data_dir, model_bundle=jb, **kw)
    ours = tswap.evaluate(ours_dir, data_dir, model_bundle=tb, **kw)
    assert set(ours) == set(ref) == {"mse", "psnr", "ssim"}
    assert np.isfinite(list(ours.values())).all()
    _assert_results(os.path.join(ours_dir, "results_swap.npz"),
                    os.path.join(ref_dir, "results_swap.npz"))
    assert sorted(os.listdir(ours_dir)) == sorted(os.listdir(ref_dir))
    _assert_archives(ours_dir, ref_dir, tswap.ARCHIVES,
                     exact={"gt_swap", "cond_swap", "target_swap"})
    # without ``images`` the digits are read from the data directory
    again = tswap.evaluate(_xp(tmp_path, "again"), data_dir, nt_pred=5, batch_size=4,
                           max_batches=2, model_bundle=tb)
    assert again == ours


def test_swap_dataset_matches_jax(data_dir):
    ours = tswap.SwapDataset(data_dir, 8, 3, 2, np.random.RandomState(1))
    ref = jswap.SwapDataset(data_dir, 8, 3, 2, np.random.RandomState(1))
    assert len(ours) == len(ref) == 16
    for i in (0, 7, 15):
        a, b = ours[i], ref[i]
        assert [x.shape for x in a] == [(3, 64, 64, 1), (5, 64, 64, 1), (2, 3, 64, 64, 1),
                                        (2, 5, 64, 64, 1)]
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    # the two permutations swap which digit rides which trajectory
    assert not np.array_equal(ours[0][3][0], ours[0][3][1])


@pytest.mark.parametrize("protocol", ["mnist", "mnist_swap"])
def test_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch, data_dir, bundles,
                                            protocol):
    _, tb = bundles
    evaluate = tmnist.evaluate if protocol == "mnist" else tswap.evaluate
    kw = dict(nt_pred=5, batch_size=4, max_batches=3, model_bundle=tb, save_arrays=False)
    full = evaluate(_xp(tmp_path, "full"), data_dir, **kw)
    xp = _xp(tmp_path, "resumed")
    real_add = tcommon.EvalProgress.add
    calls = []

    def dying_add(self, b, rows):
        real_add(self, b, rows)
        calls.append(b)
        if len(calls) == 2:
            raise RuntimeError("killed after batch 2")

    monkeypatch.setattr(tcommon.EvalProgress, "add", dying_add)
    with pytest.raises(RuntimeError, match="killed"):
        evaluate(xp, data_dir, **kw)
    monkeypatch.setattr(tcommon.EvalProgress, "add", real_add)
    progress = os.path.join(xp, f"{protocol}_t5.progress.npz")
    assert os.path.exists(progress)
    resumed = evaluate(xp, data_dir, resume=True, **kw)
    assert resumed == full
    assert not os.path.exists(progress)
    with np.load(os.path.join(xp, "results.npz" if protocol == "mnist"
                              else "results_swap.npz")) as z:
        assert z["mse"].shape == (12,)


def test_archive_cap(tmp_path, data_dir, bundles):
    _, tb = bundles
    xp = _xp(tmp_path, "capped")
    means = tmnist.evaluate(xp, data_dir, nt_pred=5, batch_size=4, max_batches=3,
                            model_bundle=tb, archive_cap=6)
    for key, fname in tmnist.ARCHIVES:
        with np.load(os.path.join(xp, fname)) as z:
            assert z[key].shape[0] == 6, key
    with np.load(os.path.join(xp, "results.npz")) as z:
        assert z["mse"].shape == (12,) and means["mse"] == float(z["mse"].mean())
    xp2 = _xp(tmp_path, "capped_swap")
    tswap.evaluate(xp2, data_dir, nt_pred=5, batch_size=4, max_batches=3,
                   model_bundle=tb, archive_cap=5)
    for key, fname in tswap.ARCHIVES:
        with np.load(os.path.join(xp2, fname)) as z:
            assert z[key].shape[0] == 5, key
    xp3 = _xp(tmp_path, "unsaved")
    tmnist.evaluate(xp3, data_dir, nt_pred=5, batch_size=4, max_batches=1,
                    model_bundle=tb, save_arrays=False)
    assert os.listdir(xp3) == ["results.npz"]


def test_bn_reestimate_and_mesh(tmp_path, data_dir, bundles):
    """``bn_reestimate`` changes the score and leaves the caller's model as it
    was; over a ``mesh`` of two CPU entries the score is the one-device
    score."""
    _, (tmodel, cfg) = bundles
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    kw = dict(nt_pred=5, batch_size=4, max_batches=1, model_bundle=(tmodel, cfg),
              save_arrays=False)
    plain = tmnist.evaluate(_xp(tmp_path, "a"), data_dir, **kw)
    fresh = tmnist.evaluate(_xp(tmp_path, "b"), data_dir, bn_reestimate=2, **kw)
    assert fresh["mse"] != plain["mse"]
    assert all(torch.equal(v, tmodel.state_dict()[k]) for k, v in before.items())
    sharded = tmnist.evaluate(_xp(tmp_path, "c"), data_dir,
                              mesh=make_mesh(devices=["cpu"] * 2), **kw)
    for k in plain:
        np.testing.assert_allclose(sharded[k], plain[k], rtol=1e-5, err_msg=k)
