"""Moving MNIST: vectorized host generator + test-set I/O.

The port's own copy of the JAX package's ``data/moving_mnist.py``, which is
numpy only; it is copied rather than imported because the port imports
nothing of the JAX package.  For the same ``RandomState`` both modules give
byte-equal trajectories, videos and test sets (``tests/test_torch_data_mnist.py``).

The reference synthesizes training videos per-item inside DataLoader worker
processes with scalar Python loops and a retroactive collision solver
(``var_sep/data/moving_mnist.py:112-303``).  Key observation: positions and
speeds are integers, walls are axis-aligned, and |speed| <= max_speed <<
frame bounds, so one reflection per axis per step is exact and the whole
collision solver vectorizes to a handful of ``np.where`` ops over all
(sequence, digit) trajectories at once.  The deterministic variant (the one
every README recipe uses — ``main.py:73-74`` passes deterministic=True) is
reproduced *exactly*, including the record-after-collision-then-advance
ordering, so test sets generated here from the reference seeds are
byte-identical in positions/speeds.

The on-device generator (closed-form triangle-fold trajectories, digits
pasted by one-hot products) lives in
:mod:`spatiotemporal_variable_separation_tpu_torch.data.mnist_device`.

MNIST images are read from raw idx files (torchvision's ``MNIST/raw``
layout or the files directly in ``data_dir``); torchvision itself is not
required (and this container has no network egress to download).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

_IDX_FILES = {
    (True, "images"): "train-images-idx3-ubyte",
    (True, "labels"): "train-labels-idx1-ubyte",
    (False, "images"): "t10k-images-idx3-ubyte",
    (False, "labels"): "t10k-labels-idx1-ubyte",
}


def _find_idx(data_dir: str, name: str) -> Optional[str]:
    for sub in ("", "MNIST/raw", "raw"):
        for suffix in ("", ".gz"):
            p = os.path.join(data_dir, sub, name + suffix)
            if os.path.exists(p):
                return p
    return None


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def load_mnist(data_dir: str, train: bool,
               require_labels: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Load MNIST digit images + labels from raw idx files.

    A missing labels file raises unless ``require_labels=False`` (training
    video synthesis never reads labels; test-set generation does)."""
    img = _find_idx(data_dir, _IDX_FILES[(train, "images")])
    lbl = _find_idx(data_dir, _IDX_FILES[(train, "labels")])
    if img is None:
        raise FileNotFoundError(
            f"MNIST idx files not found under {data_dir!r} (expected e.g. "
            f"{_IDX_FILES[(train, 'images')]}[.gz], possibly in MNIST/raw/)")
    if lbl is None and require_labels:
        raise FileNotFoundError(
            f"MNIST labels idx file not found under {data_dir!r} "
            f"({_IDX_FILES[(train, 'labels')]}[.gz])")
    images = _read_idx(img)
    labels = _read_idx(lbl) if lbl else np.zeros(len(images), np.uint8)
    return images, labels


def synthetic_digits(n: int, seed: int = 0) -> np.ndarray:
    """Random blob 'digits' for tests without MNIST files on disk."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((n, 28, 28), np.uint8)
    for i in range(n):
        cx, cy = rng.randint(8, 20, 2)
        rr, cc = np.meshgrid(np.arange(28), np.arange(28), indexing="ij")
        d = (rr - cx) ** 2 + (cy - cc) ** 2
        imgs[i] = np.clip(255 - d * rng.randint(2, 6), 0, 255).astype(np.uint8)
    return imgs


# ----------------------------------------------------------------------
# Trajectory generation (vectorized, exact integer bounce geometry)
# ----------------------------------------------------------------------

def sample_trajectories(rng: np.random.RandomState, n: int, seq_len: int,
                        frame_size: int = 64, digit_size: int = 28,
                        max_speed: int = 4, deterministic: bool = True,
                        init: Optional[np.ndarray] = None) -> np.ndarray:
    """Generate ``n`` bouncing trajectories; returns int32 (n, seq_len, 4)
    with rows [sx, sy, dx, dy].

    Both modes exactly reproduce the reference geometry
    (``moving_mnist.py:131-253``): positions are recorded after collision
    processing at each step, then the object advances by its speed.  Draw
    order (init sx, sy, dx, dy per trajectory ``:153-157``; in stochastic
    mode two resampling draws per bounce iteration ``:232-234``) matches
    the reference, so a given RandomState yields identical latents.

    Deterministic mode uses the vectorized single-reflection fast path
    (exact for integer positions/speeds); stochastic mode uses the faithful
    retroactive-intersection solver per trajectory (fractional positions,
    both speed components resampled at each bounce and the *new* speed
    applied over the remaining fraction of the timestep).

    ``init``: optional (n, 4) initial [sx, sy, dx, dy] override.
    """
    m = frame_size - digit_size  # max coordinate
    if not deterministic:
        out = np.empty((n, seq_len, 4), np.int32)
        for i in range(n):
            if init is not None:
                start = tuple(int(v) for v in init[i])
            else:
                start = None
            out[i] = _stochastic_trajectory(rng, seq_len, m, max_speed, start)
        return out

    if init is not None:
        sx, sy, dx, dy = (init[:, i].astype(np.int64).copy() for i in range(4))
    else:
        # Per-trajectory draw order matches the reference's per-digit calls.
        draws = np.empty((n, 4), np.int64)
        for i in range(n):
            draws[i, 0] = rng.randint(0, m + 1)
            draws[i, 1] = rng.randint(0, m + 1)
            draws[i, 2] = rng.randint(-max_speed, max_speed + 1)
            draws[i, 3] = rng.randint(-max_speed, max_speed + 1)
        sx, sy, dx, dy = draws[:, 0].copy(), draws[:, 1].copy(), draws[:, 2].copy(), draws[:, 3].copy()

    out = np.empty((n, seq_len, 4), np.int32)
    for t in range(seq_len):
        # Reflect at most once per axis (|d| <= max_speed <= m).
        for s, d in ((sx, dx), (sy, dy)):
            under = s < 0
            if under.any():
                s[under] = -s[under]
                d[under] = np.abs(d[under])
            over = s > m
            if over.any():
                s[over] = 2 * m - s[over]
                d[over] = -np.abs(d[over])
        out[:, t, 0], out[:, t, 1] = sx, sy
        out[:, t, 2], out[:, t, 3] = dx, dy
        sx = sx + dx
        sy = sy + dy
    return out


_EPS = 1e-8


def _stochastic_trajectory(rng, seq_len: int, m: int, max_speed: int,
                           init=None) -> np.ndarray:
    """Faithful stochastic bounce solver (reference ``moving_mnist.py:172-253``).

    At each bounce the collision point with the first crossed border is
    found retroactively, BOTH speed components are redrawn (two randints,
    same call order as the reference), signs are set away from the touched
    border(s), and the new speed is applied over the remaining fraction of
    the timestep — positions become fractional and are recorded rounded."""
    if init is None:
        sx = float(rng.randint(0, m + 1))
        sy = float(rng.randint(0, m + 1))
        dx = int(rng.randint(-max_speed, max_speed + 1))
        dy = int(rng.randint(-max_speed, max_speed + 1))
    else:
        sx, sy, dx, dy = float(init[0]), float(init[1]), int(init[2]), int(init[3])

    out = np.empty((seq_len, 4), np.int32)
    for t in range(seq_len):
        left = sx < -_EPS
        up = sy < -_EPS
        right = sx > m + _EPS
        bottom = sy > m + _EPS
        while left or right or up or bottom:
            if dx == 0:
                cx, cy = (sx, 0.0) if up else (sx, float(m))
            elif dy == 0:
                cx, cy = (0.0, sy) if left else (float(m), sy)
            else:
                a = dy / dx
                b = sy - a * sx
                cx = cy = 0.0
                if left:
                    y_at = b
                    left = -_EPS <= y_at <= m + _EPS
                    if left:
                        cx, cy = 0.0, y_at
                if right:
                    y_at = a * m + b
                    right = -_EPS <= y_at <= m + _EPS
                    if right:
                        cx, cy = float(m), y_at
                if up:
                    x_at = -b / a
                    up = -_EPS <= x_at <= m + _EPS
                    if up:
                        cx, cy = x_at, 0.0
                if bottom:
                    x_at = (m - b) / a
                    bottom = -_EPS <= x_at <= m + _EPS
                    if bottom:
                        cx, cy = x_at, float(m)
            # remaining fraction of the step, from the OLD speed
            p = (sx - cx) / dx if dx != 0 else (sy - cy) / dy
            dx = int(rng.randint(-max_speed, max_speed + 1))
            dy = int(rng.randint(-max_speed, max_speed + 1))
            if left:
                dx = abs(dx)
            if right:
                dx = -abs(dx)
            if up:
                dy = abs(dy)
            if bottom:
                dy = -abs(dy)
            sx = cx + dx * p
            sy = cy + dy * p
            left = sx < -_EPS
            up = sy < -_EPS
            right = sx > m + _EPS
            bottom = sy > m + _EPS
        out[t] = (int(round(sx)), int(round(sy)), dx, dy)
        sx += dx
        sy += dy
    return out


def composite(trajectories: np.ndarray, images: np.ndarray,
              frame_size: int = 64) -> np.ndarray:
    """Render videos from trajectories and digit images.

    ``trajectories``: (n, d, t, 4) int, ``images``: (n, d, 28, 28) uint8.
    Returns float32 (n, t, frame, frame, 1) in [0, 1] (overlaps clipped at
    255 before scaling, ``moving_mnist.py:127-128``)."""
    n, d, t, _ = trajectories.shape
    ds = images.shape[-1]
    x = np.zeros((n, t, frame_size, frame_size), np.float32)
    offs = np.arange(ds)
    full = (n, d, t, ds, ds)
    rows = np.broadcast_to(
        trajectories[..., 0][..., None, None] + offs[None, None, None, :, None], full)
    cols = np.broadcast_to(
        trajectories[..., 1][..., None, None] + offs[None, None, None, None, :], full)
    n_idx = np.broadcast_to(np.arange(n)[:, None, None, None, None], full)
    t_idx = np.broadcast_to(np.arange(t)[None, None, :, None, None], full)
    imgs = np.broadcast_to(images[:, :, None].astype(np.float32), full)
    np.add.at(x, (n_idx, t_idx, rows, cols), imgs)
    np.clip(x, None, 255.0, out=x)
    return (x / 255.0)[..., None]


# ----------------------------------------------------------------------
# Datasets
# ----------------------------------------------------------------------

class MovingMNIST:
    """Map-style Moving MNIST (reference ``moving_mnist.py:42-341``).

    Training items synthesize a fresh video; test items slice the
    precomputed npz.  Items are (cond, target) in (T, H, W, 1) layout."""

    train_length = 200_000  # virtual epoch length (moving_mnist.py:103-110)

    def __init__(self, data, nx: int, nt_cond: int, seq_len: int,
                 max_speed: int, deterministic: bool, num_digits: int,
                 train: bool, seed: int = 0):
        self.data = data
        self.frame_size = nx
        self.nt_cond = nt_cond
        self.seq_len = seq_len
        self.max_speed = max_speed
        self.deterministic = deterministic
        self.num_digits = num_digits
        self.train = train
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.train_length if self.train else len(self.data)

    def __getitem__(self, index: int):
        if not self.train:
            video = self.data[index].astype(np.float32) / 255.0  # (T,H,W,1)
            return video[: self.nt_cond], video[self.nt_cond: self.seq_len]
        video = self.generate_batch(1)[0]
        return video[: self.nt_cond], video[self.nt_cond:]

    def generate_batch(self, batch: int) -> np.ndarray:
        """Vectorized batch synthesis (the fast path for training)."""
        idx = self.rng.randint(len(self.data), size=(batch, self.num_digits))
        imgs = np.asarray(self.data)[idx]  # (b, d, 28, 28)
        trajs = sample_trajectories(
            self.rng, batch * self.num_digits, self.seq_len, self.frame_size,
            imgs.shape[-1], self.max_speed, self.deterministic)
        trajs = trajs.reshape(batch, self.num_digits, self.seq_len, 4)
        return composite(trajs, imgs, self.frame_size)

    @classmethod
    def make_dataset(cls, data_dir: str, nx: int, nt_cond: int, seq_len: int,
                     max_speed: int, deterministic: bool, num_digits: int,
                     train: bool, seed: int = 0,
                     synthetic_fallback: bool = False) -> "MovingMNIST":
        """Reference ``make_dataset`` parity (``moving_mnist.py:305-340``);
        loads digits (train) or the precomputed test npz (test)."""
        if train:
            try:
                digits, _ = load_mnist(data_dir, train=True, require_labels=False)
            except FileNotFoundError:
                if not synthetic_fallback:
                    raise
                digits = synthetic_digits(512)
            data = digits
        else:
            prefix = "" if deterministic else "s"
            path = os.path.join(data_dir, f"{prefix}mmnist_test_{num_digits}digits_{nx}.npz")
            sequences = np.load(path, allow_pickle=True)["sequences"]
            # stored layout: (T, N, 1, H, W) (make_test_set.py:88); to
            # internal per-item (T, H, W, 1).
            data = np.ascontiguousarray(
                sequences.transpose(1, 0, 3, 4, 2))  # (N, T, H, W, 1)
        return cls(data, nx, nt_cond, seq_len, max_speed, deterministic,
                   num_digits, train, seed=seed)


def make_test_set(data_dir: str, seq_len: int = 100, seed: int = 42,
                  digits: int = 2, frame_size: int = 64, max_speed: int = 4,
                  out_dir: Optional[str] = None,
                  n_seq: Optional[int] = None) -> str:
    """Generate the canonical Moving MNIST test npz
    (reference ``preprocessing/mnist/make_test_set.py``).

    RNG call order (global-equivalent RandomState: permutation, then 4
    randints per digit per sequence) matches the reference, so positions,
    speeds, labels and digit assignment are identical for a given seed.
    Saves ``sequences`` (T, N, 1, H, W) uint8, ``latents`` (T, N, digits, 4),
    ``labels`` (N, digits), ``digits`` (N, digits, 28, 28).

    ``n_seq`` (extension, default ``len(images) // digits`` = the
    reference's count): force the number of sequences.  Above the default
    the digit assignment wraps modulo the corpus (distinct trajectories,
    reused digit images) — this is how the paper-scale 5,000-sequence
    protocol runs on the stand-in corpus, whose test split holds only 500
    digits.  At or below the default the output is byte-identical to the
    unforced generator truncated to ``n_seq``."""
    rng = np.random.RandomState(seed)
    images, labels = load_mnist(data_dir, train=False)
    digits_idx = rng.permutation(len(images))
    if n_seq is None:
        n_seq = len(images) // digits
    n_traj = n_seq * digits

    # Initial conditions in the reference's exact draw order (sequence-major,
    # digit-minor, 4 randints each — make_test_set.py:71-74 via
    # _compute_trajectory :153-157); the deterministic dynamics draw nothing
    # further, so all trajectories then vectorize in one pass.
    m = frame_size - 28
    init = np.empty((n_traj, 4), np.int64)
    for i in range(n_traj):
        init[i, 0] = rng.randint(0, m + 1)
        init[i, 1] = rng.randint(0, m + 1)
        init[i, 2] = rng.randint(-max_speed, max_speed + 1)
        init[i, 3] = rng.randint(-max_speed, max_speed + 1)
    trajs = sample_trajectories(rng, n_traj, seq_len, frame_size, 28,
                                max_speed, True, init=init)
    latents = trajs.reshape(n_seq, digits, seq_len, 4)

    pick = digits_idx[np.arange(n_seq * digits) % len(images)].reshape(n_seq, digits)
    seq_objects = images[pick]
    seq_labels = labels[pick].astype(np.uint8)
    # composite + quantize per chunk: peak memory stays ~chunk-sized float32
    # instead of the full 8 GB float32 video tensor of the canonical config.
    sequences = np.empty((n_seq, seq_len, frame_size, frame_size), np.uint8)
    chunk = 256
    for s in range(0, n_seq, chunk):
        e = min(s + chunk, n_seq)
        v = composite(latents[s:e], seq_objects[s:e], frame_size)
        sequences[s:e] = (v[..., 0] * 255.0).round().astype(np.uint8)

    sequences = sequences[:, :, None]  # (N, T, 1, H, W)
    sequences = sequences.transpose(1, 0, 2, 3, 4)  # (T, N, 1, H, W)
    lat = latents.transpose(2, 0, 1, 3)  # (T, N, digits, 4)

    out_dir = out_dir or data_dir
    os.makedirs(out_dir, exist_ok=True)
    fname = os.path.join(out_dir, f"mmnist_test_{digits}digits_{frame_size}.npz")
    np.savez_compressed(fname, sequences=sequences, latents=lat,
                        labels=seq_labels, digits=seq_objects)
    return fname
