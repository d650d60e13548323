"""The port's Chairs data (``data/chairs.py``, ``data/synthetic_corpora.py``,
``cli/gen_chairs.py``, ``cli/gen_synthetic.py``) against the JAX package's,
on the CPU: the same files give the same split, shuffle, items, wraparound
and frame cache, byte for byte; ``preprocess_chairs`` writes the same PNGs;
``make_chairs`` writes the same tree, pixel for pixel.

The fixture is ``tests/test_chairs.py``'s: 8 objects of 62 views, each view a
random 64x64x3 base rolled by its index (so every view differs).
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from spatiotemporal_variable_separation_tpu.cli import gen_chairs as jgen_chairs
from spatiotemporal_variable_separation_tpu.cli import gen_synthetic as jgen_synthetic
from spatiotemporal_variable_separation_tpu.data import chairs as jchairs
from spatiotemporal_variable_separation_tpu.data import synthetic_corpora as jcorpora
from spatiotemporal_variable_separation_tpu_torch.cli import gen_chairs as tgen_chairs
from spatiotemporal_variable_separation_tpu_torch.cli import gen_synthetic as tgen_synthetic
from spatiotemporal_variable_separation_tpu_torch.data import chairs as tchairs
from spatiotemporal_variable_separation_tpu_torch.data import synthetic_corpora as tcorpora
from test_torch_eval_cli import _flags, _parser_of


@pytest.fixture(scope="module")
def chairs_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("chairs")
    rng = np.random.default_rng(0)
    root = d / "rendered_chairs"
    for obj in range(8):
        r = root / f"chair_{obj:03d}" / "renders"
        r.mkdir(parents=True)
        base = rng.integers(0, 255, (64, 64, 3), np.uint8)
        for i in range(62):
            Image.fromarray(np.roll(base, i, axis=1)).save(r / f"{i}.png")
    (root / "all_chair_names.mat").write_bytes(b"stub")
    return str(d)


@pytest.mark.parametrize("train", [True, False])
def test_split_shuffle_and_items_equal_the_jax_dataset(chairs_dir, train):
    ours = tchairs.Chairs(train, chairs_dir, nt_cond=3, seq_len=8)
    ref = jchairs.Chairs(train, chairs_dir, nt_cond=3, seq_len=8)
    assert ours.sequences == ref.sequences and "all_chair_names.mat" not in ours.sequences
    assert (ours.start_idx, ours.stop_idx) == (ref.start_idx, ref.stop_idx) == (
        (0, 6) if train else (6, 8))
    assert len(ours) == len(ref) == 62 * (6 if train else 2)
    assert ours.objects == ref.sequences[ref.start_idx:ref.stop_idx]
    for i in (0, 1, 5, 7, len(ref) - 1):
        for a, b in zip(ours[i], ref[i]):
            assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    cond, target = ours[0]
    assert cond.shape == (3, 64, 64, 3) and target.shape == (5, 64, 64, 3)


def test_wraparound_and_chosen_draws(chairs_dir):
    ours = tchairs.Chairs(True, chairs_dir, nt_cond=2, seq_len=5)
    ref = jchairs.Chairs(True, chairs_dir, nt_cond=2, seq_len=5)
    seq = ours.get_sequence(0, chosen_idx=3, chosen_id_st=60)  # views 60, 61, 0, 1, 2
    assert seq.dtype == np.uint8 and seq.shape == (5, 64, 64, 3)
    assert seq.tobytes() == ref.get_sequence(0, chosen_idx=3, chosen_id_st=60).tobytes()
    np.testing.assert_array_equal(seq[2], ours.get_sequence(0, chosen_idx=3, chosen_id_st=0)[0])
    for index, kw in ((61 * 6 + 4, {}), (9, dict(chosen_idx=5)), (13, dict(chosen_id_st=59))):
        assert ours.get_sequence(index, **kw).tobytes() == ref.get_sequence(index, **kw).tobytes()


def test_frame_cache_is_identical_and_shared(chairs_dir):
    plain = tchairs.Chairs(False, chairs_dir, nt_cond=3, seq_len=8)
    shared = {}
    a = tchairs.Chairs(False, chairs_dir, nt_cond=3, seq_len=8, cache_frames=shared)
    b = tchairs.Chairs(False, chairs_dir, nt_cond=3, seq_len=8, cache_frames=shared)
    jcached = jchairs.Chairs(False, chairs_dir, nt_cond=3, seq_len=8, cache_frames=True)
    for i in (0, 1, len(plain) - 1, 0):  # the second 0 is served from the cache
        for x, y, z in zip(plain[i], a[i], jcached[i]):
            assert x.tobytes() == y.tobytes() == z.tobytes()
    n = len(shared)
    assert n > 0 and b._frame_cache is shared
    b[1]  # every frame of item 1 is cached already
    assert len(shared) == n
    assert sorted(shared) == sorted(jcached._frame_cache)
    assert all(f.flags["C_CONTIGUOUS"] and f.shape == (64, 64, 3) for f in shared.values())
    assert tchairs.Chairs(False, chairs_dir, 3, 8, cache_frames=False)._frame_cache is None


def _raw_renders(root, n_obj=2, n_views=3):
    """500x500 RGBA renders with the 3D Warehouse file names, and a stray
    numeric name that a second preprocessing run must not take as input."""
    rng = np.random.default_rng(1)
    for obj in range(n_obj):
        d = root / "rendered_chairs" / f"obj{obj}" / "renders"
        d.mkdir(parents=True)
        for v in range(n_views):
            img = rng.integers(0, 255, (500, 500, 4), np.uint8)
            Image.fromarray(img).save(d / f"image_{v:03d}_p020_t{v * 11:03d}_r096.png")
    (root / "rendered_chairs" / "all_chair_names.mat").write_bytes(b"stub")


def test_preprocess_chairs_writes_the_jax_packages_pngs(tmp_path, monkeypatch):
    _raw_renders(tmp_path / "ours")
    shutil.copytree(tmp_path / "ours", tmp_path / "ref")
    tgen_chairs.main(["--data_dir", str(tmp_path / "ours")])
    jgen_chairs.main(["--data_dir", str(tmp_path / "ref")])
    for side in ("ours", "ref"):  # a second run changes nothing
        tchairs.preprocess_chairs(str(tmp_path / side))
    for obj in ("obj0", "obj1"):
        a = tmp_path / "ours" / "rendered_chairs" / obj / "renders"
        b = tmp_path / "ref" / "rendered_chairs" / obj / "renders"
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for v in range(3):
            out = (a / f"{v}.png").read_bytes()
            assert out == (b / f"{v}.png").read_bytes()
            assert Image.open(a / f"{v}.png").size == (64, 64)
    assert _flags(_parser_of(tgen_chairs.main, monkeypatch)) == _flags(
        _parser_of(jgen_chairs.main, monkeypatch))


def test_make_chairs_writes_the_jax_packages_tree(tmp_path):
    tcorpora.make_chairs(str(tmp_path / "ours"), n_objects=3, seed=4)
    jcorpora.make_chairs(str(tmp_path / "ref"), n_objects=3, seed=4)
    tree = {}
    for side in ("ours", "ref"):
        root = tmp_path / side / "rendered_chairs"
        tree[side] = sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, files in os.walk(root) for f in files)
    assert tree["ours"] == tree["ref"]
    assert len(tree["ours"]) == 1 + 3 * 62 and tree["ours"][0] == "all_chair_names.mat"
    for rel in tree["ours"][1:]:
        a = np.asarray(Image.open(tmp_path / "ours" / "rendered_chairs" / rel))
        b = np.asarray(Image.open(tmp_path / "ref" / "rendered_chairs" / rel))
        assert a.shape == (64, 64, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b, err_msg=rel)
    # the stand-in reads back as a dataset: 3 objects -> 2 train, 1 test
    assert len(tchairs.Chairs(True, str(tmp_path / "ours"), 5, 15)) == 2 * 62


def test_gen_synthetic(tmp_path, capsys, monkeypatch):
    tgen_synthetic.main(["chairs", "--data_dir", str(tmp_path), "--n_objects", "2",
                         "--seed", "1"])
    assert f"synthetic chairs corpus written to {tmp_path}" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "rendered_chairs")) == 3
    # taxibj and sst are written since ROADMAP items 7+8c/d (tests/test_torch_taxibj_sst_data.py
    # holds them byte-equal to the JAX package's), mnist since item 7e/8e
    # (tests/test_torch_ops_tools.py holds it)
    tgen_synthetic.main(["taxibj", "--data_dir", str(tmp_path / "taxibj"),
                         "--days_per_year", "2"])
    assert len(os.listdir(tmp_path / "taxibj")) == 4
    tgen_synthetic.main(["sst", "--data_dir", str(tmp_path / "sst"), "--zones", "3", "4",
                         "--n_days", "5", "--size", "16"])
    assert sorted(os.listdir(tmp_path / "sst")) == ["data_3.nc", "data_4.nc"]
    tgen_synthetic.main(["mnist", "--data_dir", str(tmp_path / "mnist")])
    assert sorted(os.listdir(tmp_path / "mnist" / "MNIST" / "raw")) == [
        "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte", "train-images-idx3-ubyte",
        "train-labels-idx1-ubyte"]
    assert _flags(_parser_of(tgen_synthetic.main, monkeypatch)) == _flags(
        _parser_of(jgen_synthetic.main, monkeypatch))
