"""Real-corpus readiness check: verify a data_dir against the port's loaders::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.verify_corpus \
        mnist --data_dir $DATA_DIR

The port's counterpart of the JAX package's ``cli/verify_corpus.py``, with
its flags.  The real MNIST/TaxiBJ/SST/Chairs corpora are not
redistributable, so runs validate on stand-ins (``cli.gen_synthetic``);
once the real files exist, reproducing the paper's setting should be
mechanical.  This checks a data_dir's layout (file names, shapes, dtypes,
date conventions; the reference's layouts at ``var_sep/data/
taxibj.py:103-108``, ``sst.py:24-29``, ``chairs.py:23-44``,
``moving_mnist.py:305-340``, ``wave_eq.py:29-72``) and then proves it by
building the train and eval datasets through the port's own loaders
(``data/registry.py``), the code training and evaluation run.  On success
it prints the port's train and eval commands for the benchmark (the
reference recipes, ``README.md:71-95``).  The TaxiBJ and SST files are
HDF5, read with the port's own reader (``data/hdf5.py``; no h5py).

Exit code 0 iff every check passed.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import Callable, List, Tuple

import numpy as np

MODULE = "spatiotemporal_variable_separation_tpu_torch"

#: reference README.md:71-95 flag sets, one per benchmark; {d} = data_dir,
#: {x} = xp_dir.  The eval command reproduces the paper protocol.
# One escaping rule for every command string below: the ONLY f-string
# fragment is the leading "python -m {MODULE}..." piece (which contains no
# other braces); every fragment carrying a "{x}"/"{d}" placeholder is a
# plain (non-f) continuation string, so nothing ever needs brace-escaping
# and adding/removing an f-prefix on a flag line cannot corrupt a template
# (tests/test_torch_ops_tools.py parses every printed command).
RECIPES = {
    "mnist": (
        f"python -m {MODULE}.cli.main"
        " --data mnist --epochs 800 --beta1 0.5"
        " --scheduler --precision f32 --xp_dir {x} --data_dir {d}",
        [f"python -m {MODULE}.cli.test_mnist"
         " --xp_dir {x} --data_dir {d} --nt_pred 10",
         f"python -m {MODULE}.cli.test_mnist"
         " --xp_dir {x} --data_dir {d} --nt_pred 95",
         f"python -m {MODULE}.cli.test_mnist_disentanglement"
         " --xp_dir {x} --data_dir {d} --nt_pred 10"],
    ),
    "chairs": (
        f"python -m {MODULE}.cli.main"
        " --data chairs --epochs 120"
        " --gain_resnet 0.71 --code_size_t 10 --architecture resnet"
        " --decoder_architecture dcgan --lamb_ae 1 --lamb_s 1"
        " --xp_dir {x} --data_dir {d}",
        [f"python -m {MODULE}.cli.test_chairs_disentanglement"
         " --xp_dir {x} --data_dir {d} --nt_pred 10"],
    ),
    "taxibj": (
        f"python -m {MODULE}.cli.main"
        " --data taxibj --nt_cond 4 --nt_pred 4"
        " --lr 4e-5 --batch_size 100 --epochs 550 --scheduler"
        " --scheduler_decay 0.2 --scheduler_milestones 250 300 350 400 450"
        " --offset 4 --gain_resnet 0.71 --architecture vgg --lamb_ae 45"
        " --lamb_s 0.0001 --xp_dir {x} --data_dir {d}",
        [f"python -m {MODULE}.cli.test_taxibj"
         " --xp_dir {x} --data_dir {d}"],
    ),
    "sst": (
        f"python -m {MODULE}.cli.main"
        " --data sst --nt_cond 4 --nt_pred 6"
        " --epochs 30 --code_size_t 64 --code_size_s 196 --gain_res 0.2"
        " --offset 0 --gain_resnet 0.71 --architecture encoderSST"
        " --decoder_architecture decoderSST --lamb_ae 1 --lamb_s 100"
        " --lamb_t 5e-6 --skipco --n_blocks 2 --xp_dir {x} --data_dir {d}",
        [f"python -m {MODULE}.cli.test_sst"
         " --xp_dir {x} --data_dir {d}"],
    ),
    "wave": (
        f"python -m {MODULE}.cli.main"
        " --data wave --nt_cond 5 --nt_pred 20"
        " --epochs 250 --batch_size 128 --code_size_t 32 --code_size_s 32"
        " --gain_resnet 0.71 --offset 5 --n_blocks 3 --mixing mul"
        " --architecture mlp --enc_hidden_size 1200 --dec_hidden_size 1200"
        " --dec_n_layers 4 --lamb_ae 1 --xp_dir {x} --data_dir {d}",
        [f"python -m {MODULE}.cli.test_wave"
         " --xp_dir {x} --data_dir {d}"],
    ),
    "wave_partial": (
        f"python -m {MODULE}.cli.main"
        " --data wave_partial --nt_cond 5"
        " --nt_pred 20 --epochs 250 --batch_size 128 --code_size_t 32"
        " --code_size_s 32 --gain_resnet 0.71 --offset 5 --n_blocks 3"
        " --mixing mul --architecture mlp --enc_hidden_size 2400"
        " --dec_hidden_size 150 --lamb_ae 1 --xp_dir {x} --data_dir {d}",
        [f"python -m {MODULE}.cli.test_wave"
         " --xp_dir {x} --data_dir {d}"],
    ),
}

Check = Tuple[str, Callable[[], str]]  # (label, run -> detail string)


def _layout_mnist(d: str) -> List[Check]:
    from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import (
        _IDX_FILES,
        _find_idx,
    )

    def images():
        p = _find_idx(d, _IDX_FILES[(True, "images")])
        if p is None:
            raise FileNotFoundError(
                "train-images-idx3-ubyte[.gz] not found (searched data_dir, "
                "data_dir/MNIST/raw, data_dir/raw)")
        return os.path.relpath(p, d)

    def test_npz():
        p = os.path.join(d, "mmnist_test_2digits_64.npz")
        if not os.path.isfile(p):
            raise FileNotFoundError(
                "mmnist_test_2digits_64.npz not found — generate it with "
                f"python -m {MODULE}.cli.make_mnist_test --data_dir " + d)
        with np.load(p, allow_pickle=True) as z:
            seq = z["sequences"]
            if seq.ndim != 5 or seq.shape[2] != 1 or seq.shape[3:] != (64, 64):
                raise ValueError(
                    f"sequences has shape {seq.shape}, expected (T, N, 1, 64, 64)")
            missing = {"latents", "labels", "digits"} - set(z.files)
            if missing:
                raise ValueError(
                    f"test npz lacks {sorted(missing)} (needed by the "
                    "disentanglement protocol's latent replay)")
            return f"sequences {seq.shape}, all swap-protocol keys present"

    return [("train digit idx files", images),
            ("canonical test set npz", test_npz)]


def _layout_taxibj(d: str) -> List[Check]:
    def years():
        from spatiotemporal_variable_separation_tpu_torch.data import hdf5

        found = []
        for y in (13, 14, 15, 16):
            p = os.path.join(d, f"BJ{y}_M32x32_T30_InOut.h5")
            if not os.path.isfile(p):
                raise FileNotFoundError(f"missing {os.path.basename(p)}")
            with hdf5.open(p) as f:
                if "data" not in f or "date" not in f:
                    raise ValueError(
                        f"BJ{y}: needs 'data' and 'date' datasets")
                shape = f["data"].shape
                if shape[1:] != (2, 32, 32):
                    raise ValueError(
                        f"BJ{y}: data is {shape}, expected (T, 2, 32, 32)")
                date0 = bytes(np.asarray(f["date"][0])).decode()
                if len(date0) != 10 or not date0.isdigit():
                    raise ValueError(
                        f"BJ{y}: date[0]={date0!r}, expected 'YYYYMMDDII' "
                        "(10-digit timestamp, II = 30-min slot index)")
                found.append(f"BJ{y}:{shape[0]}")
        return ", ".join(found) + " frames"

    return [("4 yearly h5 grids", years)]


def _layout_sst(d: str, zones) -> List[Check]:
    def files():
        from spatiotemporal_variable_separation_tpu_torch.data import hdf5

        lengths = {}
        for zone in zones:
            p = os.path.join(d, f"data_{zone}.nc")
            if not os.path.isfile(p):
                raise FileNotFoundError(f"missing data_{zone}.nc")
            with hdf5.open(p) as f:
                for var in ("thetao", "daily_mean", "daily_std"):
                    if var not in f:
                        raise ValueError(f"data_{zone}.nc lacks {var!r}")
                t = f["thetao"].shape
                if len(t) < 3 or t[-2:] != (64, 64):
                    raise ValueError(
                        f"data_{zone}.nc: thetao is {t}, expected (T, 64, 64)")
                lengths[zone] = t[0]
        if len(set(lengths.values())) > 1:
            # the reference assumes equal zone lengths (sst.py:66-67)
            return (f"{len(lengths)} zones, UNEQUAL lengths "
                    f"{sorted(set(lengths.values()))} — loaders handle it, "
                    "the reference's would not")
        return f"{len(lengths)} zones x {next(iter(lengths.values()))} frames"

    return [("per-zone .nc files", files)]


def _layout_chairs(d: str) -> List[Check]:
    def renders():
        root = os.path.join(d, "rendered_chairs")
        if not os.path.isdir(root):
            raise FileNotFoundError("rendered_chairs/ directory not found")
        seqs = [s for s in sorted(os.listdir(root))
                if os.path.isdir(os.path.join(root, s, "renders"))]
        if not seqs:
            raise FileNotFoundError(
                "rendered_chairs/ has no <obj>/renders/ directories")
        first = os.path.join(root, seqs[0], "renders")
        pngs = list(os.listdir(first))
        numeric = [f for f in pngs if f.endswith(".png")
                   and os.path.splitext(f)[0].isdigit()]
        if not numeric:
            raise FileNotFoundError(
                f"{seqs[0]}/renders/ has no preprocessed {{i}}.png frames — "
                f"run python -m {MODULE}.cli.gen_chairs --data_dir " + d)
        from PIL import Image

        with Image.open(os.path.join(first, numeric[0])) as im:
            if im.size != (64, 64):
                raise ValueError(
                    f"render is {im.size}, expected 64x64 — run gen_chairs")
        return f"{len(seqs)} objects, {len(numeric)} renders in the first"

    return [("rendered_chairs PNG tree", renders)]


def _layout_wave(d: str, partial: bool) -> List[Check]:
    from spatiotemporal_variable_separation_tpu_torch.data.wave_eq import _load_simul

    def sims():
        base = os.path.join(d, "data")
        if not os.path.isdir(base):
            raise FileNotFoundError("data/ subdirectory not found — generate "
                                    f"with python -m {MODULE}.cli.gen_wave")
        files = [f for f in os.listdir(base) if f.startswith("homogenous_wave")]
        if not files:
            raise FileNotFoundError("no homogenous_wave{i}.pt/.npz files")
        sim = _load_simul(os.path.join(base, sorted(files)[0]))
        if sim.shape[-2:] != (64, 64):
            raise ValueError(f"simulation frames are {sim.shape}, expected "
                             "(T, 64, 64)")
        return f"{len(files)} simulations, first {sim.shape}"

    checks = [("wave simulations", sims)]
    if partial:
        def pixels():
            p = os.path.join(d, "pixels", "pixels.npz")
            if not os.path.isfile(p):
                raise FileNotFoundError(
                    "pixels/pixels.npz not found — generate with "
                    f"python -m {MODULE}.cli.gen_pixels --data_dir " + d)
            with np.load(p) as z:
                if "rand_w" not in z or "rand_h" not in z:
                    raise ValueError("pixels.npz lacks rand_w/rand_h")
                return f"{len(z['rand_w'])} sampled pixels"

        checks.append(("pixel subsampling file", pixels))
    return checks


def _loader_proof(benchmark: str, d: str, zones=range(1, 30)) -> List[Check]:
    """Construct the real train + eval datasets through the production
    loaders (the same code paths cli.main / the eval CLIs run)."""
    from spatiotemporal_variable_separation_tpu_torch.core.config import ExperimentConfig
    from spatiotemporal_variable_separation_tpu_torch.data.registry import (
        make_train_dataset,
    )

    defaults = dict(
        mnist=dict(data="mnist"),
        chairs=dict(data="chairs", architecture="resnet",
                    decoder_architecture="dcgan", code_size_t=10),
        taxibj=dict(data="taxibj", architecture="vgg", nt_cond=4, nt_pred=4,
                    offset=4, batch_size=100),
        sst=dict(data="sst", architecture="encoderSST",
                 decoder_architecture="decoderSST", mixing="concat",
                 code_size_s=196, code_size_t=64, skipco=True, nt_cond=4,
                 nt_pred=6, offset=0, n_blocks=2, zones=list(zones)),
        wave=dict(data="wave", architecture="mlp", mixing="mul",
                  code_size_s=32, code_size_t=32, offset=5, n_blocks=3),
        wave_partial=dict(data="wave_partial", architecture="mlp",
                          mixing="mul", code_size_s=32, code_size_t=32,
                          offset=5, n_blocks=3, enc_hidden_size=2400,
                          dec_hidden_size=150),
    )[benchmark]
    cfg = ExperimentConfig(data_dir=d, **defaults).validate()

    def train_set():
        ds = make_train_dataset(cfg)
        cond, target = ds[0][0], ds[0][1]
        n = len(ds)
        return (f"{n} samples; cond {np.shape(cond)} "
                f"{np.asarray(cond).dtype}, target {np.shape(target)}")

    def eval_set():
        seq_len = cfg.nt_cond + cfg.nt_pred
        if benchmark == "mnist":
            from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import (
                MovingMNIST,
            )

            ds = MovingMNIST.make_dataset(d, 64, cfg.nt_cond, seq_len, 4,
                                          True, 2, train=False)
        elif benchmark == "chairs":
            from spatiotemporal_variable_separation_tpu_torch.data.chairs import Chairs

            ds = Chairs(False, d, cfg.nt_cond, seq_len)
        elif benchmark == "taxibj":
            from spatiotemporal_variable_separation_tpu_torch.data.taxibj import TaxiBJ

            ds = TaxiBJ.make_datasets(d, len_closeness=seq_len,
                                      nt_cond=cfg.nt_cond)[1]
        elif benchmark == "sst":
            from spatiotemporal_variable_separation_tpu_torch.data.sst import SST

            # paper protocol holds out zones 17-20 (test/sst/test.py:37)
            ds = SST(d, cfg.nt_cond, 10, train=False, zones=range(17, 21),
                     eval=True)
        else:
            from spatiotemporal_variable_separation_tpu_torch.data.wave_eq import (
                WaveEq,
                WaveEqPartial,
            )

            # eval protocol: nt_pred hardcoded 40 (test/wave/test.py:74-75)
            if benchmark == "wave_partial":
                ds = WaveEqPartial(d, cfg.nt_cond, cfg.nt_cond + 40, False,
                                   cfg.downsample, cfg.n_wave_points)
            else:
                ds = WaveEq(d, cfg.nt_cond, cfg.nt_cond + 40, False,
                            cfg.downsample)
        cond = ds[0][0]
        return f"{len(ds)} samples; cond {np.shape(cond)}"

    return [("train loader constructs", train_set),
            ("eval loader constructs", eval_set)]


def verify(benchmark: str, data_dir: str, xp_dir: str = "$XP_DIR",
           zones=range(1, 30), log_fn=print, debug: bool = False) -> bool:
    layout = {
        "mnist": lambda: _layout_mnist(data_dir),
        "chairs": lambda: _layout_chairs(data_dir),
        "taxibj": lambda: _layout_taxibj(data_dir),
        "sst": lambda: _layout_sst(data_dir, zones),
        "wave": lambda: _layout_wave(data_dir, False),
        "wave_partial": lambda: _layout_wave(data_dir, True),
    }[benchmark]()
    ok = True
    log_fn(f"== {benchmark}: {data_dir}")
    for label, run in layout + _loader_proof(benchmark, data_dir, zones):
        try:
            detail = run()
            log_fn(f"  ok   {label}: {detail}")
        except Exception as e:  # noqa: BLE001 — every failure is a report
            ok = False
            log_fn(f"  FAIL {label}: {type(e).__name__}: {e}")
            if debug:
                traceback.print_exc()
    if ok:
        train_cmd, eval_cmds = RECIPES[benchmark]
        log_fn("  corpus ready — reproduce the paper setting with:")
        log_fn("    " + train_cmd.format(d=data_dir, x=xp_dir))
        for cmd in eval_cmds:
            log_fn("    " + cmd.format(d=data_dir, x=xp_dir))
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="varsep corpus verifier (PyTorch)", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("benchmark", choices=sorted(RECIPES) + ["all"])
    p.add_argument("--data_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--xp_dir", type=str, metavar="DIR", default="$XP_DIR",
                   help="Substituted into the printed commands.")
    p.add_argument("--zones", type=int, nargs="+",
                   default=list(range(1, 30)), help="SST zones to check.")
    p.add_argument("--debug", action="store_true",
                   help="Print full tracebacks for failing checks.")
    args = p.parse_args(argv)
    names = sorted(RECIPES) if args.benchmark == "all" else [args.benchmark]
    ok = all([verify(n, args.data_dir, args.xp_dir, args.zones,
                     debug=args.debug)
              for n in names])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
