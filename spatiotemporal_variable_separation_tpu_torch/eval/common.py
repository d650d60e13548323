"""Shared evaluation machinery: the ``Evaluator`` (forecast and score on the
device) and the host-side helpers of every protocol.

Torch counterpart of the JAX package's ``eval/common.py``.  A batch's score
comes back as a few (B,) metric arrays, while its frames and S code stay on
the device; only the archive path fetches frames.  The host-side helpers
(``batch_indices``, ``EvalProgress``, ``write_eval_json``,
``to_uint8_nchw_last``, ``FrameArchive``) are the port's own copies of the
JAX module's numpy code, which the port cannot import (that module imports
JAX at its top).
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.ops.metrics import mse_per_frame, psnr_from_mse
from spatiotemporal_variable_separation_tpu_torch.ops.ssim import ssim_per_frame
from spatiotemporal_variable_separation_tpu_torch.parallel.mesh import (
    device_put,
    replicated_sharding,
    shard_batch,
    tree_map,
)

_METRICS = ("mse", "psnr", "ssim")


class Evaluator:
    """Forecasts and scores with one model on one device, or data-parallel
    over the entries of a one-process ``mesh`` (``parallel.make_mesh``).

    The Evaluator keeps its own copy of the model, in eval mode, on the
    model's device: the caller's module is never put in another mode nor
    has its BatchNorm statistics changed (the JAX Evaluator updates its own
    copy of ``variables``, ``common.py:154-172``).

    With a mesh (JAX ``common.py:98-118``) it keeps one replica a mesh entry
    (``replicas``; ``model`` is the first, on the first entry's device).
    Each batch is padded to a mesh multiple by repeating its last row
    (``_pad``), split on its leading axis, each shard run on its replica,
    and the results gathered to the first device in shard order and sliced
    back.  Eval-mode rows do not interact, so the forecast is the one-device
    forecast row for row; an f32/``mixed`` MLP-ResNet launches the rollout
    kernel once a shard a batch.
    """

    def __init__(self, model: torch.nn.Module, mesh=None):
        if mesh is not None and mesh.in_group:
            raise ValueError("Evaluator shards over the entries of a one-process mesh "
                             "(make_mesh(devices=...)), not over a process group")
        self.model = copy.deepcopy(model).eval()
        self.mesh = mesh
        self.replicas = [self.model]
        if mesh is not None:
            self.replicas = device_put(self.model, replicated_sharding(mesh))
            self.model = self.replicas[0]
        self.device = next(self.model.parameters()).device

    def _pad(self, x):
        """The batch (a tree) padded to a mesh multiple by repeating its last
        row (JAX ``common.py:175-182``)."""
        short = -_rows(x) % len(self.replicas)
        if not short:
            return x
        return tree_map(lambda a: torch.cat([a, a[-1:].expand((short,) + a.shape[1:])]), x)

    def _sharded(self, fn, *batches):
        """``fn(replica, *shards)`` on every replica's shard of the batches
        (trees whose leading axis is the batch), the results (trees of
        batch-leading tensors, or None) gathered to the first device in
        shard order and cut to the batch."""
        if self.mesh is None:
            return fn(self.model, *batches)
        b = _rows(batches[0])
        shards = shard_batch(self.mesh, tuple(self._pad(x) for x in batches))
        outs = [fn(rep, *shard) for rep, shard in zip(self.replicas, shards)]

        def gather(*parts):
            if parts[0] is None:
                return None
            if isinstance(parts[0], (tuple, list)):
                return type(parts[0])(gather(*p) for p in zip(*parts))
            return torch.cat([p.to(self.device) for p in parts])[:b]

        return gather(*outs)

    def _get_forecast(self, cond: torch.Tensor, n_forecast: int, init_s_code: Any = None):
        """``model.get_forecast`` over the mesh's shards (an S code given is
        sharded with the batch)."""
        if init_s_code is None:
            return self._sharded(lambda m, c: m.get_forecast(c, n_forecast), cond)
        return self._sharded(lambda m, c, s: m.get_forecast(c, n_forecast, init_s_code=s),
                             cond, init_s_code)

    def _tensor(self, x) -> torch.Tensor:
        """A host array (or a tensor) as a tensor on the evaluator's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    def reestimate_batch_stats(self, cond_batches, n_forecast: int) -> int:
        """Refresh the BatchNorm running statistics from forward rollouts.

        Runs the full ``get_forecast`` in train mode, without gradients, over
        the given conditioning batches, so each pass folds its batch
        statistics into the running averages in the JAX package's call order
        (``common.py:121-173``), then returns to eval mode.  Conditioning
        windows only (model inputs, never eval targets).  Returns the number
        of batches consumed."""
        if not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in self.model.modules()):
            return 0
        n = 0
        self.model.train()
        try:
            with torch.no_grad():
                for cond in cond_batches:
                    cond = self._tensor(cond)
                    if self.mesh is not None:
                        # TRIM (not pad) to a mesh multiple, as JAX does
                        # (common.py:156-168): _pad's repeated rows would
                        # bias the statistics.  The trimmed batch runs
                        # whole through one replica: its statistics are
                        # those of the global batch.
                        cond = cond[:cond.shape[0] - cond.shape[0] % len(self.replicas)]
                        if not cond.shape[0]:
                            continue
                    self.model.get_forecast(cond, n_forecast)
                    n += 1
        finally:
            self.model.eval()
        stats = {k: v for k, v in self.model.state_dict().items() if "running_" in k}
        for rep in self.replicas[1:]:
            rep.load_state_dict(stats, strict=False)
        return n

    @torch.inference_mode()
    def forecast(self, cond, n_forecast: int, init_s_code: Any = None):
        """``(forecasts (B, n, H, W, C), S)`` on the device; with
        ``init_s_code`` the S code is taken as given."""
        fc, _, s, _ = self._get_forecast(self._tensor(cond), n_forecast, init_s_code)
        return fc, s

    @torch.inference_mode()
    def score(self, cond, gt, nt_skip: int, max_val: float = 1.0):
        """Roll out ``nt_skip + gt.shape[1]`` frames and score the prediction
        window against ``gt`` on the device.

        Returns ``(metrics, pred, s)``: host ``(B,)`` mse/psnr/ssim arrays,
        and the prediction window and S code, left on the device."""
        cond, gt = self._tensor(cond), self._tensor(gt)
        fc, _, s, _ = self._get_forecast(cond, nt_skip + gt.shape[1])
        pred = fc[:, nt_skip:]
        return _fetch(per_sequence_metrics(pred, gt, max_val)), pred, s

    @torch.inference_mode()
    def score_swap(self, content_cond, test_cond, gt_swap, nt_skip: int,
                   max_val: float = 1.0):
        """Disentanglement scoring: S from ``content_cond``, dynamics from
        ``test_cond``, metrics against ``gt_swap``.  With a permutation axis,
        ``gt_swap`` (B, n_perms, P, H, W, C), every digit-to-trajectory
        assignment is scored and the best kept per metric, independently
        (min MSE, max PSNR, max SSIM; ``common.py:66-89``).

        Returns ``(metrics, pred)``: host ``(B,)`` arrays and the prediction
        window on the device."""
        content_cond, test_cond = self._tensor(content_cond), self._tensor(test_cond)
        gt_swap = self._tensor(gt_swap)
        per_perm = gt_swap.dim() == test_cond.dim() + 1
        gt_len = gt_swap.shape[2] if per_perm else gt_swap.shape[1]
        s = self._sharded(lambda m, c: m.encode_s(c), content_cond)
        fc = self._get_forecast(test_cond, nt_skip + gt_len, s)[0]
        pred = fc[:, nt_skip:]
        if not per_perm:
            return _fetch(per_sequence_metrics(pred, gt_swap, max_val)), pred
        b, n_perms = gt_swap.shape[:2]
        # Every permutation against the one prediction, in one pass.
        tiled = pred.unsqueeze(1).expand((b, n_perms) + tuple(pred.shape[1:]))
        per = per_sequence_metrics(tiled.reshape((b * n_perms,) + tuple(pred.shape[1:])),
                                   gt_swap.reshape((b * n_perms,) + tuple(gt_swap.shape[2:])),
                                   max_val)
        per = {k: v.reshape(b, n_perms) for k, v in per.items()}
        mets = {"mse": per["mse"].amin(dim=1), "psnr": per["psnr"].amax(dim=1),
                "ssim": per["ssim"].amax(dim=1)}
        return _fetch(mets), pred


def _rows(tree) -> int:
    """The leading (batch) size of a tree's first tensor."""
    while isinstance(tree, (tuple, list)):
        tree = tree[0]
    return tree.shape[0]


def _fetch(mets: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device (B,) metric tensors -> host f32 arrays, in one copy."""
    host = torch.stack([mets[k] for k in _METRICS]).cpu().numpy()
    return dict(zip(_METRICS, host))


def bn_reestimate_pass(ev: Evaluator, dataset, batch_size: int,
                       n_forecast: int, n_batches: int, seed: int = 0) -> int:
    """Refresh the evaluator's BatchNorm running statistics from
    ``n_batches`` random conditioning batches of a map-style ``(cond,
    target, ...)`` dataset.  No-op when ``n_batches`` <= 0 (the default,
    the reference's protocol)."""
    if n_batches <= 0:
        return 0
    rng = np.random.RandomState(seed)
    n = len(dataset)

    def batches():
        for _ in range(n_batches):
            idx = rng.randint(0, n, size=batch_size)
            yield np.stack([np.asarray(dataset[i][0]) for i in idx])

    return ev.reestimate_batch_stats(batches(), n_forecast)


def batch_indices(n: int, batch_size: int, max_batches: Optional[int] = None,
                  progress_every: float = 30.0):
    """Yield ``(indices, n_real)`` with the last batch padded to
    ``batch_size`` by repeating the final index, so every batch has one
    shape; callers slice results to ``n_real``.

    Prints a progress line to stderr after the first batch, then at most
    every ``progress_every`` seconds and after the last (0 disables)."""
    if n <= 0:
        raise ValueError("evaluation dataset is empty (0 items) — check the "
                         "data directory / split / horizon configuration")
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    n_batches = (n + batch_size - 1) // batch_size
    if max_batches:
        n_batches = min(n_batches, max_batches)
    t0 = time.monotonic()
    last_emit = None
    for b in range(n_batches):
        lo = b * batch_size
        hi = min(lo + batch_size, n)
        idx = list(range(lo, hi))
        n_real = len(idx)
        idx = idx + [idx[-1]] * (batch_size - n_real)
        yield idx, n_real
        # control is back: the caller finished scoring batch b.
        now = time.monotonic()
        if progress_every and (last_emit is None
                               or now - last_emit > progress_every
                               or b == n_batches - 1):
            print(f"[eval] batch {b + 1}/{n_batches} done "
                  f"({now - t0:.0f}s elapsed)", file=sys.stderr, flush=True)
            last_emit = now


def per_sequence_metrics(pred: torch.Tensor, gt: torch.Tensor,
                         max_val: float = 1.0) -> Dict[str, torch.Tensor]:
    """Per-sequence MSE, PSNR and SSIM as ``(B,)`` f32 tensors on the
    device (reference ``test/mnist/test.py:136-142``: spatial mean, then
    channel mean, then time mean)."""
    mse = mse_per_frame(pred, gt)  # (B, T, C)
    psnr = psnr_from_mse(mse, max_val)
    ssim = ssim_per_frame(pred, gt, max_val)
    return {"mse": mse.mean(dim=(1, 2)), "psnr": psnr.mean(dim=(1, 2)),
            "ssim": ssim.mean(dim=(1, 2))}


def pixel_metrics(pred, gt, max_val: float = 1.0) -> Dict[str, np.ndarray]:
    """Host-side variant of :func:`per_sequence_metrics`: arrays or tensors
    in, host arrays out (computed where the tensors are, on the CPU for
    arrays)."""
    as_t = (lambda x: x if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(x)))
    with torch.inference_mode():
        return _fetch(per_sequence_metrics(as_t(pred), as_t(gt), max_val))


def to_uint8_nchw_last(x) -> np.ndarray:
    """(B, T, H, W, C) floats (an array, or a tensor anywhere) -> the
    reference's archived (B, T, H, W, C) uint8 layout (it permutes NCHW to
    NHWC before saving)."""
    if isinstance(x, torch.Tensor):
        x = x.float().cpu().numpy()
    return np.clip(np.asarray(x) * 255.0, 0, 255).astype(np.uint8)


class FrameArchive:
    """Bounded accumulator of (cond, gt, pred) batches -> npz archives.

    The first ``cap`` sequences are kept as float16 and written in the
    layout the JAX package's ``cli.visualize`` renders (predictions.npz /
    gt.npz / cond.npz, arrays (B, T, H, W, C)); the protocols other than
    Moving MNIST archive through it."""

    def __init__(self, cap: int = 64):
        self.cap = cap
        self._rows = {"cond": [], "gt": [], "predictions": []}
        self._mse = []
        self._n = 0

    def add(self, cond, gt, pred, mse: Optional[np.ndarray] = None) -> None:
        """``mse``: per-sequence scalars of the same batch, written to
        results.npz."""
        take = min(self.cap - self._n, len(pred))
        if take <= 0:
            return
        host = (lambda x: x.float().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x))
        self._rows["cond"].append(np.asarray(host(cond)[:take], np.float16))
        self._rows["gt"].append(np.asarray(host(gt)[:take], np.float16))
        self._rows["predictions"].append(np.asarray(host(pred)[:take], np.float16))
        if mse is not None:
            self._mse.append(np.asarray(mse[:take], np.float64))
        self._n += take

    def save(self, xp_dir: str, log_fn=print) -> None:
        if not self._n:
            return
        for key, fname in [("predictions", "predictions.npz"),
                           ("gt", "gt.npz"), ("cond", "cond.npz")]:
            np.savez_compressed(os.path.join(xp_dir, fname),
                                **{key: np.concatenate(self._rows[key])})
        if self._mse:
            np.savez_compressed(os.path.join(xp_dir, "results.npz"),
                                mse=np.concatenate(self._mse))
        log_fn(f"archived {self._n} sequence(s) (cap {self.cap}) to {xp_dir}")


class EvalProgress:
    """Batch-level checkpoint and resume for the eval CLIs.

    Every completed batch's per-sequence metric rows are written to
    ``<xp_dir>/<name>.progress.npz`` (a few floats a sequence), so a rerun
    with ``resume=True`` skips the batches already scored.  The file carries
    a fingerprint of the protocol (``meta``); one that does not match starts
    over.  :meth:`finalize` deletes it when the protocol completes.

    Usage::

        prog = EvalProgress(xp_dir, "mnist_t95", meta, resume=args.resume)
        for b, (idx, n_real) in enumerate(batch_indices(...)):
            if prog.skip(b):
                continue
            ...score batch...
            prog.add(b, {"mse": rows, ...})
        results = prog.arrays()
        prog.finalize()
    """

    def __init__(self, xp_dir: Optional[str], name: str, meta: Dict[str, Any],
                 resume: bool = False, log_fn=print):
        self.path = (os.path.join(xp_dir, f"{name}.progress.npz")
                     if xp_dir else None)
        self.meta = {k: meta[k] for k in sorted(meta)}
        self.done = 0
        self._rows: Dict[str, list] = {}
        if resume and self.path and os.path.exists(self.path):
            with np.load(self.path, allow_pickle=False) as z:
                stored = json.loads(str(z["meta"]))
                if stored == {k: _json_safe(v) for k, v in self.meta.items()}:
                    self.done = int(z["done"])
                    self._rows = {k: [np.asarray(z[k])] for k in z.files
                                  if k not in ("meta", "done")}
                    log_fn(f"[eval] resume: {self.done} batch(es) already "
                           f"scored in {self.path}")
                else:
                    log_fn("[eval] progress file does not match this "
                           "protocol configuration — starting over")

    def skip(self, b: int) -> bool:
        return b < self.done

    def add(self, b: int, rows: Dict[str, np.ndarray]) -> None:
        """Record batch ``b``'s per-sequence metric rows and persist them.

        Batches must arrive in order; the write is atomic (a temporary file,
        then a rename), so a kill mid-write leaves the previous state."""
        if b != self.done:
            raise ValueError(f"batch {b} out of order (expected {self.done})")
        for k, v in rows.items():
            self._rows.setdefault(k, []).append(np.asarray(v, np.float64))
        self.done += 1
        if not self.path:
            return
        payload = {k: np.concatenate(v) for k, v in self._rows.items()}
        payload["done"] = np.int64(self.done)
        payload["meta"] = np.str_(json.dumps(
            {k: _json_safe(v) for k, v in self.meta.items()}))
        tmp = self.path + ".tmp.npz"  # np.savez keeps a name ending in .npz
        np.savez(tmp, **payload)
        os.replace(tmp, self.path)

    def arrays(self) -> Dict[str, np.ndarray]:
        """All recorded per-sequence rows, concatenated in batch order."""
        return {k: np.concatenate(v) for k, v in self._rows.items()}

    def finalize(self) -> None:
        if self.path and os.path.exists(self.path):
            os.unlink(self.path)


def _json_safe(v):
    """A scalar that survives the fingerprint's JSON round trip."""
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def write_eval_json(xp_dir: str, protocol: str, means: Dict[str, float],
                    **extra) -> str:
    """Merge a protocol's metric means into ``<xp_dir>/evals.json`` as
    ``{protocol: {metric: value, ..., **extra, "unix_time": t}}`` (the last
    run of a protocol wins).

    Means are stored as floats; ``extra`` run metadata (epoch,
    bn_reestimate, max_batches) keeps its types.  A lock file serializes
    concurrent writers on one xp_dir, so the read-merge-write cannot drop
    another protocol's record; a lock older than 10 s belongs to a killed
    writer and is removed.  Scoring a pinned checkpoint (``epoch=N``)
    records under ``"<protocol>@epN"``."""
    if extra.get("epoch") is not None:
        protocol = f"{protocol}@ep{extra['epoch']}"
    path = os.path.join(xp_dir, "evals.json")
    lock = path + ".lock"
    stale_age_s = 10.0  # live writers hold the lock for milliseconds
    fd = None
    while True:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            break
        except FileExistsError:
            # Never write without the lock: a stale one is unlinked and the
            # acquisition retried; a fresh one is waited on.
            try:
                stale = time.time() - os.path.getmtime(lock) > stale_age_s
            except OSError:
                continue  # the lock vanished: retry now
            if stale:
                try:
                    os.unlink(lock)
                except OSError:
                    pass
                continue
            time.sleep(0.1)
    try:
        try:
            with open(path) as f:
                record = json.load(f)
        except (FileNotFoundError, ValueError):
            record = {}
        record[protocol] = {**{k: float(v) for k, v in means.items()},
                            **extra, "unix_time": time.time()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    finally:
        os.close(fd)
        try:
            os.unlink(lock)
        except OSError:
            pass
    return path
