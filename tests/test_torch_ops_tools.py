"""The port's operations tooling against the JAX package's, on the CPU:
``cli/summarize.py``, ``utils/viz.py`` and ``cli/visualize.py``,
``cli/verify_corpus.py``, ``utils/helper.py`` and ``cli/gen_synthetic.py
mnist`` (``data/synthetic_corpora.py:make_mnist_standin``).

* summarize: the same digest (returned dict and printed lines) as the JAX
  package's on the same directories, among them one the port trained with
  ``--monitor_stability``;
* viz: the same pixels as the JAX package's ``utils.viz`` on the same
  arrays, in memory and in the PNGs ``visualize`` writes for every
  ``--rank``, from an archive the port's eval wrote;
* verify_corpus: every benchmark's stand-in passes, an empty directory
  fails, every printed command parses against the port's own CLIs, and a
  missing h5py fails the HDF5 corpora by name;
* the MNIST stand-in: the four idx files hash to the pinned sha256 below
  (``chip_smoke.py`` phase 14e holds the card machine's files to the same
  constants), need neither scikit-learn nor cv2, and equal the JAX
  package's files byte for byte but for the glyphs' cubic upsampling: the
  JAX package uses cv2, whose default (optimized) path rounds its f32 sums
  its own way, and the two differ by 1 (of 255) on 2 of the 718,800 glyph
  pixels (measured with cv2 5.0.0; the port's f64 sums are within an f32
  rounding of the exact interpolant).
"""

import argparse
import builtins
import hashlib
import importlib
import json
import os
import shlex
import sys

import numpy as np
import pytest
from PIL import Image

import spatiotemporal_variable_separation_tpu.data.synthetic_corpora as jcorpora
from spatiotemporal_variable_separation_tpu.cli import summarize as jsummarize
from spatiotemporal_variable_separation_tpu.cli import verify_corpus as jverify
from spatiotemporal_variable_separation_tpu.cli import visualize as jvisualize
from spatiotemporal_variable_separation_tpu.utils import helper as jhelper
from spatiotemporal_variable_separation_tpu.utils import viz as jviz
from spatiotemporal_variable_separation_tpu_torch.cli import gen_synthetic as tgen_synthetic
from spatiotemporal_variable_separation_tpu_torch.cli import summarize as tsummarize
from spatiotemporal_variable_separation_tpu_torch.cli import verify_corpus as tverify
from spatiotemporal_variable_separation_tpu_torch.cli import visualize as tvisualize
from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
from spatiotemporal_variable_separation_tpu_torch.data import synthetic_corpora as tcorpora
from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import (
    make_test_set,
    synthetic_digits,
)
from spatiotemporal_variable_separation_tpu_torch.data.wave_eq import (
    generate_dataset,
    generate_pixels,
)
from spatiotemporal_variable_separation_tpu_torch.eval.common import FrameArchive
from spatiotemporal_variable_separation_tpu_torch.train.loop import run_training
from spatiotemporal_variable_separation_tpu_torch.utils import helper as thelper
from spatiotemporal_variable_separation_tpu_torch.utils import viz as tviz
from conftest import write_idx_images
from torch_threads import few_torch_threads  # noqa: F401

#: sha256 of ``gen_synthetic mnist --seed 0`` (``MNIST/raw/<file>``), as the
#: port writes them on every machine (``chip_smoke.py`` pins the same).
MNIST_STANDIN_SHA256 = {
    "t10k-images-idx3-ubyte": "cb3385a9b99f9b3b13c948b0554a02d0eef407b209d998ccf910ded4c3468938",
    "t10k-labels-idx1-ubyte": "957a673c0182b877a1b3a65c73ac4bf4e7dc94b49f1621c2da5ee997be1728ce",
    "train-images-idx3-ubyte": "f5b66961e04f1062bf50ce4d6353db409c38aa9e4bdb2bb144443d8ac351a1dd",
    "train-labels-idx1-ubyte": "6300936e6f8242fe267f7cbc323bd574be8f9184c5effdd4dbf00c8fe62146ff",
}


# -- summarize ------------------------------------------------------------------

def _xp_digest(xp):
    (xp / "checkpoints" / "10").mkdir(parents=True)
    (xp / "checkpoints" / "final").mkdir()
    (xp / "checkpoints" / ".tmp.final.123").mkdir()  # a staging dir: never a checkpoint
    (xp / "params.json").write_text(json.dumps(
        {"data": "wave", "architecture": "mlp", "epochs": 2,
         "batch_size": 8, "precision": "f32", "steps_per_epoch": 3}))
    with open(xp / "metrics.csv", "w") as f:
        f.write("step,wall_s,ae,forecast,loss,s_inv,t_reg,samples_per_sec\n")
        for s in range(1, 7):
            f.write(f"{s},{s}.0,{0.1/s},{0.2/s},{1.0/s},{0.01/s},{2.0/s},{100+s}\n")
        f.write("7,7.0,bad,row,,,,\n")  # partial line from a killed writer
    with open(xp / "stability.csv", "w") as f:
        f.write("step,wall_s,stability_gain,stability_s_mean_abs,stability_bn_max_var,"
                "samples_per_sec\n")
        for s in range(1, 8):
            f.write(f"{s},{s}.0,{1 + s / 100},{s},{10 * s},\n")


def _xp_evals(xp):
    (xp / "params.json").write_text(json.dumps({"data": "sst"}))
    (xp / "evals.json").write_text(json.dumps(
        {"sst": {"mse_t10": 1.5, "epoch": None, "bn_reestimate": 0,
                 "reference_broadcast": False, "zones": [17, 18], "unix_time": 1.0},
         "wave": {"mse_t40": 7.9e-05, "epoch": None, "unix_time": 1.0}}))


def _root(root):
    for name, data in (("a_wave", "wave"), ("b_mnist", "mnist")):
        (root / name).mkdir()
        (root / name / "params.json").write_text(json.dumps(
            {"data": data, "architecture": "mlp", "precision": "f32"}))
    (root / "a_wave" / "evals.json").write_text(json.dumps(
        {"wave": {"mse_t40": 1e-4, "unix_time": 1.0}}))
    (root / "not_an_xp").mkdir()
    (root / "broken").mkdir()
    (root / "broken" / "params.json").write_text('{"data": "wa')  # truncated


SUMMARY_CASES = {"digest": _xp_digest, "evals": _xp_evals, "empty": lambda xp: None}


def _both(fn_name, path, **kw):
    """(the JAX result and lines, the port's result and lines)."""
    out = []
    for mod in (jsummarize, tsummarize):
        lines = []
        out.append((getattr(mod, fn_name)(str(path), log_fn=lines.append, **kw), lines))
    return out


@pytest.mark.parametrize("case", list(SUMMARY_CASES))
def test_summarize_matches_jax(case, tmp_path):
    xp = tmp_path / "xp"
    xp.mkdir()
    SUMMARY_CASES[case](xp)
    (ref, ref_lines), (out, lines) = _both("summarize", xp, points=3)
    assert out == ref and lines == ref_lines
    if case == "digest":
        assert out["checkpoints"] == ["final", "10"] and out["steps_logged"] == 6
        assert out["samples_per_sec_median"] == 104 and out["stability"]["step"] == 7
        assert any("stability gain/step (last 6 probes)" in line for line in lines)
    if case == "evals":
        assert "eval wave: mse_t40=7.9e-05" in lines and "unix_time" not in "\n".join(lines)
    if case == "empty":
        assert "curve" not in out and "no metrics.csv" in lines


def test_summarize_all_matches_jax(tmp_path):
    _root(tmp_path)
    (ref, ref_lines), (rows, lines) = _both("summarize_all", tmp_path)
    assert rows == ref and lines == ref_lines
    assert [r["name"] for r in rows] == ["a_wave", "b_mnist"]
    assert any("broken" in line and "unreadable" in line for line in lines)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _both("summarize_all", empty)[1][0] == []


def test_summarize_a_port_run(tmp_path, capsys):
    """A directory the port trained (with ``--monitor_stability``) digests as
    the JAX package's summarize digests it; the CLI prints the same."""
    data = tmp_path / "data"
    data.mkdir()
    write_idx_images(str(data / "train-images-idx3-ubyte"), synthetic_digits(16))
    xp = tmp_path / "xp"
    xp.mkdir()
    cfg = ExperimentConfig(data="mnist", architecture="dcgan", code_size_s=16, code_size_t=8,
                           enc_hidden_size=8, dec_hidden_size=8, res_hidden_size=16,
                           nt_cond=2, nt_pred=3, offset=2, batch_size=4, precision="f32",
                           epochs=2, steps_per_epoch=2, chkpt_interval=1, xp_dir=str(xp),
                           data_dir=str(data))
    cfg.save(str(xp / "params.json"))
    run_training(cfg, device="cpu", log_every=1, monitor_stability=True, log_fn=lambda _: None)
    (ref, ref_lines), (out, lines) = _both("summarize", xp)
    assert out == ref and lines == ref_lines
    assert out["checkpoints"] == ["final", "1", "2"] and out["steps_logged"] == 4
    assert out["stability"]["step"] == 4 and out["config"]["data"] == "mnist"
    tsummarize.main(["--xp_dir", str(xp)])
    assert capsys.readouterr().out.splitlines() == lines
    tsummarize.main(["--root", str(tmp_path)])
    assert capsys.readouterr().out.startswith("xp ")


# -- viz and visualize ----------------------------------------------------------

def test_strip_matches_jax():
    rng = np.random.default_rng(0)
    rows = {"cond": rng.random((3, 16, 16, 1)).astype(np.float16),
            "gt": (rng.random((7, 16, 16, 2)) * 255).astype(np.uint8),  # TaxiBJ's 2 flows
            "pred": rng.standard_normal((7, 16, 16, 3)),
            "swap": np.full((2, 16, 16, 1), 7.0)}  # a degenerate range
    for kw in ({}, {"max_t": 5}, {"max_t": 2, "pad": 1, "label_px": 4}):
        np.testing.assert_array_equal(tviz.strip(rows, **kw), jviz.strip(rows, **kw))
    for seq in rows.values():
        np.testing.assert_array_equal(tviz._to_uint8_frames(seq), jviz._to_uint8_frames(seq))
    img = tviz.strip({"cond": rows["cond"], "pred": rows["pred"]}, max_t=5, pad=2, label_px=8)
    assert img.shape == (2 * 16 + 3 * 2, 8 + 5 * 16 + 6 * 2, 3) and img.dtype == np.uint8


def _archive(xp, rng, swap=False):
    """An eval archive as the port writes it (``eval/common.py:FrameArchive``)."""
    archive = FrameArchive(cap=6)
    cond = rng.random((8, 5, 16, 16, 1)).astype(np.float32)
    gt, pred = (rng.random((8, 9, 16, 16, 1)).astype(np.float32) for _ in range(2))
    archive.add(cond, gt, pred, mse=rng.random(8))
    archive.save(str(xp), log_fn=lambda _: None)
    if swap:  # the MNIST swap protocol's extra archives
        for key in ("content_swap", "cond_swap", "target_swap"):
            np.savez_compressed(xp / f"{key}.npz",
                                **{key: (rng.random((6, 9, 16, 16, 1)) * 255).astype(np.uint8)})


@pytest.mark.parametrize("rank", ["first", "best", "worst", "spread"])
def test_visualize_writes_the_jax_packages_pngs(rank, tmp_path, capsys):
    _archive(tmp_path, np.random.default_rng(1), swap=rank == "spread")
    pngs = {}
    for name, cli in (("jax", jvisualize), ("port", tvisualize)):
        cli.main(["--xp_dir", str(tmp_path), "--n", "4", "--rank", rank, "--max_t", "6",
                  "--out", str(tmp_path / name)])
        pngs[name] = sorted(os.listdir(tmp_path / name))
    assert pngs["port"] == pngs["jax"] and len(pngs["port"]) == (8 if rank == "spread" else 4)
    for f in pngs["port"]:
        a = np.asarray(Image.open(tmp_path / "port" / f))
        np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "jax" / f)), f)
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"wrote 4 strip(s) to {tmp_path / 'port'}")
    with pytest.raises(FileNotFoundError, match="no predictions.npz"):
        tvisualize.main(["--xp_dir", str(tmp_path / "port")])


# -- verify_corpus --------------------------------------------------------------

def _verify(benchmark, data_dir, **kw):
    lines = []
    ok = tverify.verify(benchmark, str(data_dir), log_fn=lines.append, **kw)
    return ok, "\n".join(lines)


STANDINS = {  # benchmark: (make the stand-in in d, verify kwargs)
    "mnist": (lambda d: (tcorpora.make_mnist_standin(d, seed=3, n_test=100),
                         make_test_set(d)), {}),
    "chairs": (lambda d: tcorpora.make_chairs(d, n_objects=7), {}),
    "taxibj": (lambda d: tcorpora.make_taxibj(d, days_per_year=40), {}),
    "sst": (lambda d: tcorpora.make_sst(d, zones=list(range(1, 30)), n_days=80),
            {"zones": list(range(1, 30))}),
    "wave": (lambda d: generate_dataset(d, size=5, seq_len=100, batch=5, device="cpu"), {}),
    "wave_partial": (lambda d: (generate_dataset(d, size=5, seq_len=100, batch=5,
                                                 device="cpu"),
                                generate_pixels(d, number=100)), {}),
}


@pytest.mark.parametrize("benchmark", list(STANDINS))
def test_verify_corpus_standin_passes(benchmark, tmp_path):
    make, kw = STANDINS[benchmark]
    make(str(tmp_path))
    ok, out = _verify(benchmark, tmp_path, **kw)
    assert ok, out
    assert "corpus ready" in out and "FAIL" not in out
    train_cmd, eval_cmds = tverify.RECIPES[benchmark]
    assert train_cmd.format(d=tmp_path, x="$XP_DIR") in out
    assert all(cmd.format(d=tmp_path, x="$XP_DIR") in out for cmd in eval_cmds)
    # the JAX package's verifier takes the port's stand-in too (same layouts)
    assert jverify.verify(benchmark, str(tmp_path), log_fn=lambda _: None, **kw)


def test_verify_corpus_fails_where_files_are_missing(tmp_path):
    for benchmark in ("mnist", "chairs", "taxibj", "sst", "wave", "wave_partial"):
        ok, out = _verify(benchmark, tmp_path)
        assert not ok and "FAIL" in out and "corpus ready" not in out, benchmark
    tcorpora.make_mnist_standin(str(tmp_path), seed=3, n_test=100)
    ok, out = _verify("mnist", tmp_path)
    assert not ok and "make_mnist_test" in out  # the exact fix
    generate_dataset(str(tmp_path), size=5, seq_len=100, batch=5, device="cpu")
    ok, out = _verify("wave_partial", tmp_path)
    assert not ok and "gen_pixels" in out
    assert tverify.main(["wave", "--data_dir", str(tmp_path)]) == 0
    assert tverify.main(["taxibj", "--data_dir", str(tmp_path)]) == 1


def test_verify_corpus_names_a_missing_h5py(tmp_path, monkeypatch):
    """The card machine has no h5py: the HDF5 corpora fail, naming it."""
    tcorpora.make_taxibj(str(tmp_path), days_per_year=40)
    real_import = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py":
            raise ModuleNotFoundError("No module named 'h5py'", name="h5py")
        return real_import(name, *args, **kw)

    monkeypatch.delitem(sys.modules, "h5py", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    for benchmark in ("taxibj", "sst"):
        ok, out = _verify(benchmark, tmp_path, zones=[1])
        fails = [line for line in out.splitlines() if "FAIL" in line]
        assert not ok and fails and all("h5py" in line for line in fails), out


class _Parsed(Exception):
    """Raised right after a successful parse."""


def test_printed_commands_parse_against_the_ports_clis(monkeypatch):
    """Every command the port's verifier prints names a port CLI, and that
    CLI's own parser accepts it."""
    real = argparse.ArgumentParser.parse_args

    def probe(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", probe)
    assert sorted(tverify.RECIPES) == sorted(jverify.RECIPES)
    for benchmark, (train_cmd, eval_cmds) in tverify.RECIPES.items():
        jtrain, jevals = jverify.RECIPES[benchmark]
        for cmd, jcmd in zip([train_cmd] + eval_cmds, [jtrain] + jevals):
            argv = shlex.split(cmd.format(d="/tmp/d", x="/tmp/x"))
            assert argv[:2] == ["python", "-m"], cmd
            assert argv[2].startswith("spatiotemporal_variable_separation_tpu_torch.cli.")
            # the JAX package's recipe, flag for flag
            assert argv[3:] == shlex.split(jcmd.format(d="/tmp/d", x="/tmp/x"))[3:]
            with pytest.raises(_Parsed):
                importlib.import_module(argv[2]).main(argv[3:])


# -- helper ---------------------------------------------------------------------

def test_helper_matches_jax(tmp_path):
    (tmp_path / "c.json").write_text(json.dumps({"a": 1, "b": {"c": 2}}))
    (tmp_path / "c.yaml").write_text("a: 1\nb:\n  c: 2\n")
    for path, load in (("c.json", "load_json"), ("c.yaml", "load_yaml")):
        ours = getattr(thelper, load)(str(tmp_path / path))
        assert isinstance(ours, thelper.DotDict)
        assert ours == getattr(jhelper, load)(str(tmp_path / path)) == {"a": 1, "b": {"c": 2}}
        assert ours.a == 1
    d = thelper.DotDict(x=1)
    d.y = 2
    assert d == {"x": 1, "y": 2}
    del d.x
    assert d == {"y": 2}
    with pytest.raises(AttributeError, match="dt"):  # strict, not the reference's None
        d.dt


# -- the MNIST stand-in ---------------------------------------------------------

def _files(root):
    raw = os.path.join(root, "MNIST", "raw")
    return {f: open(os.path.join(raw, f), "rb").read() for f in sorted(os.listdir(raw))}


def test_gen_synthetic_mnist_is_pinned_and_needs_neither_sklearn_nor_cv2(
        tmp_path, monkeypatch, capsys):
    for name in ("sklearn", "cv2"):  # an import of either now fails
        monkeypatch.setitem(sys.modules, name, None)
    tgen_synthetic.main(["mnist", "--data_dir", str(tmp_path)])
    assert f"synthetic mnist corpus written to {tmp_path}" in capsys.readouterr().out
    files = _files(tmp_path)
    assert {f: hashlib.sha256(b).hexdigest() for f, b in files.items()} == MNIST_STANDIN_SHA256
    images, labels = tcorpora.load_digits()
    assert images.shape == (1797, 8, 8) and labels.shape == (1797,)
    assert images.max() == 16 and np.bincount(labels).min() >= 170  # ~180 of each digit


def test_mnist_standin_matches_the_jax_packages_files(tmp_path):
    """Byte-equal but for 2 glyph pixels, off by 1 (the module docstring)."""
    pytest.importorskip("sklearn")
    pytest.importorskip("cv2")
    tcorpora.make_mnist_standin(str(tmp_path / "port"))
    jcorpora.make_mnist_standin(str(tmp_path / "jax"))
    ours, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(ours) == list(ref)
    off = 0
    for f in ours:
        a, b = np.frombuffer(ours[f], np.uint8), np.frombuffer(ref[f], np.uint8)
        assert a.shape == b.shape and a[:16].tobytes() == b[:16].tobytes(), f  # idx headers
        diff = np.abs(a.astype(int) - b)
        assert diff.max() <= 1, f
        off += int((diff > 0).sum())
        if "images" not in f:
            assert ours[f] == ref[f], f  # the labels and the split: equal
    assert off == 2


def test_digits_are_scikit_learns(tmp_path):
    sklearn_datasets = pytest.importorskip("sklearn.datasets")
    bunch = sklearn_datasets.load_digits()
    images, labels = tcorpora.load_digits()
    np.testing.assert_array_equal(images, bunch.images)
    np.testing.assert_array_equal(labels, bunch.target)


def test_resize_cubic_is_cv2s_inter_cubic():
    """Within an f32 rounding of cv2's INTER_CUBIC on the digits (values
    0-16: 1e-5 absolute), and exactly cv2's kernel on an impulse."""
    cv2 = pytest.importorskip("cv2")
    images, _ = tcorpora.load_digits()
    ours = tcorpora.resize_cubic(images, 20, 20)
    ref = np.stack([cv2.resize(im.astype(np.float32), (20, 20),
                               interpolation=cv2.INTER_CUBIC) for im in images])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    impulse = np.zeros((1, 8, 8), np.float32)
    impulse[0, 3, 4] = 1.0
    wide = tcorpora.resize_cubic(impulse, 8, 20)  # rows unchanged: weights 0, 1, 0, 0
    np.testing.assert_allclose(
        wide[0, 3], cv2.resize(impulse[0], (20, 8), interpolation=cv2.INTER_CUBIC)[3],
        rtol=0, atol=3e-7)
