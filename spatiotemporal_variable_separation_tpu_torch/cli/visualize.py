"""Render eval archives into filmstrip PNGs::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.visualize \
        --xp_dir X [--n 8] [--rank spread] [--max_t 20] [--scale 2]

The port's counterpart of the JAX package's ``cli/visualize.py``, with its
flags.  The port's eval CLIs archive the conditioning, ground truth and
predictions (and the content swaps) in the JAX package's layout
(``predictions.npz``, ``gt.npz``, ``cond.npz``, ``results.npz``; as the
reference, ``test/mnist/test.py:162-168``); this renders them as labelled
strips, one PNG a sequence.  ``--rank`` picks the sequences by the
per-sequence MSE of ``results.npz``: ``first`` (archive order), ``best``,
``worst`` or ``spread`` (quantiles from best to worst, the default).
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(prog="varsep eval visualization (PyTorch)")
    p.add_argument("--xp_dir", type=str, metavar="DIR", required=True)
    p.add_argument("--out", type=str, metavar="DIR", default=None,
                   help="Output directory (default <xp_dir>/frames).")
    p.add_argument("--n", type=int, metavar="N", default=8)
    p.add_argument("--rank", choices=["first", "best", "worst", "spread"],
                   default="spread")
    p.add_argument("--max_t", type=int, metavar="T", default=20)
    p.add_argument("--scale", type=int, metavar="S", default=2)
    args = p.parse_args(argv)

    import numpy as np

    from spatiotemporal_variable_separation_tpu_torch.utils.viz import save_strip

    def load(name):
        path = os.path.join(args.xp_dir, name + ".npz")
        if not os.path.isfile(path):
            return None
        with np.load(path) as d:
            return d[name] if name in d.files else d[d.files[0]]

    preds = load("predictions")
    if preds is None:
        raise FileNotFoundError(
            f"no predictions.npz under {args.xp_dir!r} — run an eval CLI "
            "first (they archive the arrays this renders)")
    n_seq = len(preds)
    order = np.arange(n_seq)
    results_path = os.path.join(args.xp_dir, "results.npz")
    if args.rank != "first" and os.path.isfile(results_path):
        with np.load(results_path) as d:
            mse = d["mse"] if "mse" in d.files else None
        if mse is not None and len(mse) == n_seq:
            order = np.argsort(mse)
            if args.rank == "worst":
                order = order[::-1]
            elif args.rank == "spread":
                q = np.linspace(0, n_seq - 1, min(args.n, n_seq)).astype(int)
                order = order[q]
    picks = order[:args.n]

    out_dir = args.out or os.path.join(args.xp_dir, "frames")
    os.makedirs(out_dir, exist_ok=True)
    roles = {k: load(k) for k in ("cond", "gt", "content_swap",
                                  "cond_swap", "target_swap")}
    for rank_pos, i in enumerate(picks):
        rows = {}
        if roles["cond"] is not None:
            rows["cond"] = roles["cond"][i]
        if roles["gt"] is not None:
            rows["gt"] = roles["gt"][i]
        rows["pred"] = preds[i]
        path = os.path.join(out_dir, f"seq_{rank_pos:02d}_idx{int(i):04d}.png")
        save_strip(path, rows, max_t=args.max_t, scale=args.scale)
        if roles["content_swap"] is not None:
            swap_rows = {}
            if roles["cond_swap"] is not None:
                swap_rows["cond_swap"] = roles["cond_swap"][i]
            if roles["target_swap"] is not None:
                swap_rows["target_swap"] = roles["target_swap"][i]
            swap_rows["content_swap"] = roles["content_swap"][i]
            save_strip(os.path.join(
                out_dir, f"swap_{rank_pos:02d}_idx{int(i):04d}.png"),
                swap_rows, max_t=args.max_t, scale=args.scale)
    print(f"wrote {len(picks)} strip(s) to {out_dir}")


if __name__ == "__main__":
    main()
