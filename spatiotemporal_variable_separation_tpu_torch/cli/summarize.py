"""Run summary CLI: a learning-curve digest of training directories::

    python -m spatiotemporal_variable_separation_tpu_torch.cli.summarize --xp_dir X [--points 8]
    python -m spatiotemporal_variable_separation_tpu_torch.cli.summarize --root DIR

The port's counterpart of the JAX package's ``cli/summarize.py``, with its
flags, over the files the port writes in the JAX package's layout: the
config echo from ``params.json``, the checkpoint names, the ``evals.json``
records, the loss curve and throughput from ``metrics.csv``
(``utils/profiling.py:MetricsLogger``) and the ``--monitor_stability`` trail
from ``stability.csv``.  It imports neither torch nor the model code.
"""

from __future__ import annotations

import argparse
import csv
import json
import os


def load_rows(path: str):
    with open(path, newline="") as f:
        rows = []
        for row in csv.DictReader(f):
            try:
                rows.append({k: float(v) for k, v in row.items() if v != ""})
            except ValueError:
                continue  # partial line from a killed writer
    return rows


def _format_eval_line(rec: dict) -> str:
    """Display the metric means of one evals.json protocol record.

    ``write_eval_json`` stores metric means as floats and run metadata
    (epoch, bn_reestimate, zones, ...) with their original types, so
    "float-valued and not unix_time" selects exactly the metrics."""
    return "  ".join(f"{k}={v:.4g}" for k, v in sorted(rec.items())
                     if type(v) is float and k != "unix_time")


def summarize(xp_dir: str, points: int = 8, log_fn=print) -> dict:
    """Digest one experiment dir; returns the machine-readable summary."""
    params_path = os.path.join(xp_dir, "params.json")
    metrics_path = os.path.join(xp_dir, "metrics.csv")
    out: dict = {"xp_dir": xp_dir}
    if os.path.isfile(params_path):
        with open(params_path) as f:
            p = json.load(f)
        out["config"] = {k: p.get(k) for k in
                         ("data", "architecture", "decoder_architecture",
                          "epochs", "batch_size", "precision",
                          "steps_per_epoch")}
        log_fn(f"{p.get('data')}/{p.get('architecture')}"
               f" epochs={p.get('epochs')} batch={p.get('batch_size')}"
               f" precision={p.get('precision')}")
    ckpt_dir = os.path.join(xp_dir, "checkpoints")
    if os.path.isdir(ckpt_dir):
        # dot-prefixed entries are save_checkpoint staging/retired dirs
        # (checkpoint.list_checkpoints invariant), never checkpoints;
        # filtered inline to keep this CLI free of torch imports.
        names = sorted((n for n in os.listdir(ckpt_dir)
                        if not n.startswith(".")),
                       key=lambda n: (n != "final", int(n) if n.isdigit() else 0))
        out["checkpoints"] = names
        log_fn(f"checkpoints: {len(names)} ({', '.join(names[:12])}"
               + (", ..." if len(names) > 12 else "") + ")")
    # eval protocol results (eval CLIs merge into evals.json); read before
    # the metrics.csv early-out — an eval'd dir may have no training log.
    evals_path = os.path.join(xp_dir, "evals.json")
    if os.path.isfile(evals_path):
        try:
            with open(evals_path) as f:
                out["evals"] = json.load(f)
        except ValueError:
            out["evals"] = {}
        for proto, rec in sorted(out["evals"].items()):
            log_fn(f"eval {proto}: {_format_eval_line(rec)}")
    if not os.path.isfile(metrics_path):
        log_fn("no metrics.csv")
        return out
    rows = load_rows(metrics_path)
    if not rows:
        log_fn("metrics.csv empty")
        return out
    last = rows[-1]
    out["steps_logged"] = int(last.get("step", 0))
    sps = [r["samples_per_sec"] for r in rows if "samples_per_sec" in r]
    if sps:
        out["samples_per_sec_median"] = sorted(sps)[len(sps) // 2]
        log_fn(f"throughput (median of {len(sps)} epochs): "
               f"{out['samples_per_sec_median']:.0f} samples/s")
    # evenly spaced curve points, always including first and last
    idx = sorted({0, len(rows) - 1,
                  *(i * (len(rows) - 1) // max(points - 1, 1)
                    for i in range(points))})
    keys = [k for k in ("loss", "ae", "s_inv", "forecast", "t_reg")
            if k in rows[0]]
    log_fn("step        " + "  ".join(f"{k:>10}" for k in keys))
    curve = []
    for i in idx:
        r = rows[i]
        curve.append({k: r.get(k) for k in ("step", *keys)})
        log_fn(f"{int(r['step']):<10}  "
               + "  ".join(f"{r.get(k, float('nan')):>10.3e}" for k in keys))
    out["curve"] = curve
    # stability probe trail (--monitor_stability runs write stability.csv)
    stab_path = os.path.join(xp_dir, "stability.csv")
    if os.path.isfile(stab_path):
        srows = load_rows(stab_path)
        if srows:
            s = srows[-1]
            out["stability"] = {k: s.get(k) for k in
                                ("step", "stability_gain",
                                 "stability_s_mean_abs",
                                 "stability_bn_max_var")}
            trail = " -> ".join(f"{r.get('stability_gain', float('nan')):.3f}"
                                for r in srows[-min(len(srows), 6):])
            log_fn(f"stability gain/step (last {min(len(srows), 6)} probes): "
                   f"{trail}; BN max var {s.get('stability_bn_max_var', 0):.3g}")
    return out


def summarize_all(root: str, points: int = 8, log_fn=print) -> list:
    """One-line-per-experiment digest of every xp dir under ``root``.

    An "experiment dir" is any directory (depth 1) containing params.json.
    Each row: name, recipe, precision, steps logged, median throughput, and
    every evals.json headline metric. Returns the machine-readable rows."""
    rows = []
    names = sorted(n for n in os.listdir(root)
                   if os.path.isfile(os.path.join(root, n, "params.json")))
    if not names:
        log_fn(f"no experiment dirs under {root}")
        return rows
    for name in names:
        xp = os.path.join(root, name)
        try:
            out = summarize(xp, points=points, log_fn=lambda *_: None)
        except Exception as e:  # e.g. params.json truncated by a killed writer
            log_fn(f"{name:<16} unreadable: {e}")
            continue
        cfg = out.get("config", {})
        row = {"name": name, **out}
        rows.append(row)
        head = (f"{name:<16} {cfg.get('data', '?')}/{cfg.get('architecture', '?')}"
                f" prec={cfg.get('precision', '?')}"
                f" steps={out.get('steps_logged', 0)}")
        if "samples_per_sec_median" in out:
            head += f" {out['samples_per_sec_median']:.0f} samples/s"
        log_fn(head)
        for proto, rec in sorted(out.get("evals", {}).items()):
            log_fn(f"  {proto}: {_format_eval_line(rec)}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(prog="varsep run summary (PyTorch)")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--xp_dir", type=str, metavar="DIR",
                   help="digest one experiment directory")
    g.add_argument("--root", type=str, metavar="DIR",
                   help="aggregate every experiment directory under DIR")
    p.add_argument("--points", type=int, metavar="N", default=8)
    args = p.parse_args(argv)
    if args.root:
        summarize_all(args.root, args.points)
    else:
        summarize(args.xp_dir, args.points)


if __name__ == "__main__":
    main()
