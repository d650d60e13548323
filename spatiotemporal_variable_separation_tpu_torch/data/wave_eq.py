"""WaveEq: the RK4 wave simulator on the card, and its datasets.

Torch counterpart of the JAX package's ``data/wave_eq.py:50-270``
(reference ``var_sep/preprocessing/wave/gen_wave.py:37-138``,
``var_sep/data/wave_eq.py:29-90``).  The 2-D wave equation

    w'' = c^2 * Lap(w) + f0 * exp(-invT0 * t) * mask

is integrated as a first-order system by a fixed-step fourth-order
Runge-Kutta, with the whole batch of sequences as one tensor program over
(c, f0) on the given device.  The reference integrates through
torchdiffeq 0.0.1's ``method='rk4'``, the 3/8-rule tableau, which is the
default (``tableau="38"``); ``tableau="classic"`` is standard RK4.  The
Laplacian is a pair of shifted-slice sums, 5-point (4th order) or 3-point,
that leave the boundary rows and columns' contributions at zero, as the
reference's loop bounds do (``gen_wave.py:69-83``).

The JAX package integrates with XLA, not Pallas; this is torch ops, no
kernel of its own.  XLA may fuse a product and a sum into one rounding
where ATen rounds twice, so the frames agree with the JAX package's within
a tolerance relative to each frame's max, not bitwise; the draws of f0 and
c are numpy's and byte-equal.

Datasets: per-sequence min-max normalization, time downsampling, sliding
windows; ``WaveEqPartial`` observes fixed random pixels.  The length is
``n_sequences * (nt - seq_len + 1)`` as in the JAX package (the
reference's ``__len__`` uses the frame height).  The dataset and
``generate_pixels`` are numpy, the port's own copy of the JAX module's.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device


def circle_mask(size: int = 64, center=(32, 32), r: int = 5, device=None) -> torch.Tensor:
    """f32 disk mask with the reference's strict ``< r^2`` (``gen_wave.py:31-34``)."""
    ii = torch.arange(size, device=device)[:, None]
    jj = torch.arange(size, device=device)[None, :]
    return (((jj - center[0]) ** 2 + (ii - center[1]) ** 2) < r * r).to(torch.float32)


def laplacian(w: torch.Tensor, order: int = 5) -> torch.Tensor:
    """FD Laplacian over the last two axes with zero boundary contributions:
    ``order=5`` the 5-point 4th-order stencil on [2, n-2), ``order=3`` the
    3-point one on [1, n-1)."""
    out = torch.zeros_like(w)
    if order == 3:
        out[..., :, 1:-1] += w[..., :, 2:] - 2.0 * w[..., :, 1:-1] + w[..., :, :-2]
        out[..., 1:-1, :] += w[..., 2:, :] - 2.0 * w[..., 1:-1, :] + w[..., :-2, :]
        return out
    if order == 5:
        c2, c1, c0 = -1.0 / 12.0, 4.0 / 3.0, -5.0 / 2.0
        out[..., :, 2:-2] += (c2 * w[..., :, 4:] + c1 * w[..., :, 3:-1] + c0 * w[..., :, 2:-2]
                              + c1 * w[..., :, 1:-3] + c2 * w[..., :, :-4])
        out[..., 2:-2, :] += (c2 * w[..., 4:, :] + c1 * w[..., 3:-1, :] + c0 * w[..., 2:-2, :]
                              + c1 * w[..., 1:-3, :] + c2 * w[..., :-4, :])
        return out
    raise ValueError(f"unsupported stencil order {order}")


@torch.no_grad()
def simulate_wave(c, f0, seq_len: int = 300, frame_size: int = 64, dt: float = 0.001,
                  invT0: float = 20.0, order: int = 5, circular: bool = True,
                  tableau: str = "38", device=None) -> torch.Tensor:
    """Integrate wave sequences: ``c``/``f0`` scalars or (N,) -> f32
    (seq_len, H, W) or (N, seq_len, H, W) of w, on ``device`` (the card
    unless the caller asks for the CPU).  Frame 0 is the zero initial
    condition."""
    if tableau not in ("38", "classic"):
        raise ValueError(f"tableau must be '38' or 'classic', got {tableau!r}")
    device = resolve_device(device, "simulate_wave")
    c = torch.as_tensor(c, dtype=torch.float32).to(device)
    f0 = torch.as_tensor(f0, dtype=torch.float32).to(device)
    scalar = c.dim() == 0
    c, f0 = c.reshape(-1, 1, 1), f0.reshape(-1, 1, 1)
    c2 = c ** 2
    source = f0 * circle_mask(frame_size, r=5 if circular else 1, device=device)

    # The source's decay at every stage's time, computed once: f32 times as
    # the JAX package forms them (t + h/3 etc. rounded to f32), then exp.
    third = dt / 3.0
    ts = torch.arange(seq_len - 1, dtype=torch.float32, device=device) * dt
    offsets = (0.0, third, 2 * third, dt) if tableau == "38" else (0.0, dt / 2, dt / 2, dt)
    decay = torch.stack([torch.exp(-invT0 * (ts + o)) for o in offsets], dim=1)

    def f(e, w, wd):
        return wd, c2 * laplacian(w, order) + e * source

    w = torch.zeros((c.shape[0], frame_size, frame_size), dtype=torch.float32, device=device)
    wd = torch.zeros_like(w)
    frames = torch.empty((c.shape[0], seq_len, frame_size, frame_size), dtype=torch.float32,
                         device=device)
    frames[:, 0] = w
    for k in range(seq_len - 1):
        e = decay[k]
        k1 = f(e[0], w, wd)
        if tableau == "38":  # the torchdiffeq 'rk4' step function
            k2 = f(e[1], w + third * k1[0], wd + third * k1[1])
            k3 = f(e[2], w + dt * (k2[0] - k1[0] / 3.0), wd + dt * (k2[1] - k1[1] / 3.0))
            k4 = f(e[3], w + dt * (k1[0] - k2[0] + k3[0]), wd + dt * (k1[1] - k2[1] + k3[1]))
            w, wd = (w + dt / 8 * (k1[0] + 3 * k2[0] + 3 * k3[0] + k4[0]),
                     wd + dt / 8 * (k1[1] + 3 * k2[1] + 3 * k3[1] + k4[1]))
        else:
            k2 = f(e[1], w + dt / 2 * k1[0], wd + dt / 2 * k1[1])
            k3 = f(e[2], w + dt / 2 * k2[0], wd + dt / 2 * k2[1])
            k4 = f(e[3], w + dt * k3[0], wd + dt * k3[1])
            w, wd = (w + dt / 6 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0]),
                     wd + dt / 6 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1]))
        frames[:, k + 1] = w
    return frames[0] if scalar else frames


def draw_parameters(size: int, seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """f32 (f0, c) of ``size`` sequences, drawn f0 then c per sequence from
    ``RandomState(seed)`` (``gen_wave.py:121-130``)."""
    rng = np.random.RandomState(seed)
    f0s = np.empty(size, np.float32)
    cs = np.empty(size, np.float32)
    for i in range(size):
        f0s[i] = rng.uniform(1, 30)
        cs[i] = rng.uniform(300, 400)
    return f0s, cs


def generate_dataset(data_dir: str, size: int = 300, seq_len: int = 300,
                     frame_size: int = 64, dt: float = 0.001, seed: int = 42,
                     batch: int = 32, fmt: str = "npz", device=None) -> None:
    """Generate the WaveEq dataset, integrated on ``device`` (the card unless
    the caller asks for the CPU), ``batch`` sequences at a time.

    Writes ``data/homogenous_wave{i}.npz`` with fields ``simul`` (f32
    (seq_len, H, W)) and ``c``, or with ``fmt="pt"`` torch pickles in the
    reference generator's layout (``{'simul': FloatTensor, 'c': float}``,
    ``gen_wave.py:138``), the JAX package's file names and fields."""
    if fmt not in ("npz", "pt"):
        raise ValueError(f"fmt must be 'npz' or 'pt', got {fmt!r}")
    device = resolve_device(device, "generate_dataset")
    out_dir = os.path.join(data_dir, "data")
    os.makedirs(out_dir, exist_ok=True)
    f0s, cs = draw_parameters(size, seed)
    for start in range(0, size, batch):
        stop = min(start + batch, size)
        sims = simulate_wave(cs[start:stop], f0s[start:stop], seq_len=seq_len,
                             frame_size=frame_size, dt=dt, device=device).cpu()
        for j, i in enumerate(range(start, stop)):
            if fmt == "pt":
                torch.save({"simul": sims[j].clone(), "c": float(cs[i])},
                           os.path.join(out_dir, f"homogenous_wave{i}.pt"))
            else:
                np.savez(os.path.join(out_dir, f"homogenous_wave{i}.npz"),
                         simul=sims[j].numpy(), c=cs[i])


def _load_simul(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path)["simul"].astype(np.float32)
    d = torch.load(path, map_location="cpu", weights_only=True)
    return np.asarray(d["simul"], dtype=np.float32)


class WaveEq:
    """Sliding-window dataset over simulated wave sequences.

    Items are ``(cond, target)`` numpy arrays in (T, H, W, 1) layout.
    Train/test split: the first 80% of the sequence files by index
    (``data/wave_eq.py:41-46``)."""

    def __init__(self, data_dir: str, nt_cond: int, seq_len: int, train: bool,
                 downsample: int = 2):
        self.nt_cond = nt_cond
        self.seq_len = seq_len
        base = os.path.join(data_dir, "data")

        def seq_id(name):
            return int(re.findall(r"\d+", name)[0])

        files = sorted(os.listdir(base), key=seq_id)
        max_seq = int(0.8 * len(files))
        files = [f for f in files if (seq_id(f) < max_seq) == train]
        data = []
        for f in files:
            simul = _load_simul(os.path.join(base, f))
            mx, mn = simul.max(), simul.min()
            simul = (simul - mn) / (mx - mn)
            data.append(simul[::downsample])
        self.data = np.stack(data)[..., None]  # (N, nt, H, W, 1)
        self.nt = self.data.shape[1]
        self.windows = self.nt - self.seq_len + 1
        if self.windows <= 0:
            raise ValueError(
                f"seq_len={seq_len} exceeds the {self.nt} frames available "
                f"after downsampling by {downsample}; generate longer "
                f"sequences (cli.gen_wave --seq_len >= {seq_len * downsample})")

    def __len__(self) -> int:
        return self.data.shape[0] * self.windows

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        i, j = divmod(idx, self.windows)
        window = self.data[i, j:j + self.seq_len]
        return window[: self.nt_cond], window[self.nt_cond: self.seq_len]


class WaveEqPartial(WaveEq):
    """Fixed-random-pixel observations (WaveEq-100): frames become
    (n_pixels, 1), at the coordinates of ``pixels/pixels.npz`` (fields
    rand_w/rand_h, ``gen_pixels.py:48-52``)."""

    def __init__(self, data_dir: str, nt_cond: int, seq_len: int, train: bool,
                 downsample: int = 2, n_pixels: int = 100):
        super().__init__(data_dir, nt_cond, seq_len, train, downsample)
        pix = np.load(os.path.join(data_dir, "pixels", "pixels.npz"))
        self.rand_w = pix["rand_w"][:n_pixels]
        self.rand_h = pix["rand_h"][:n_pixels]

    def __getitem__(self, idx: int):
        cond, target = super().__getitem__(idx)
        return (cond[:, self.rand_w, self.rand_h, :],
                target[:, self.rand_w, self.rand_h, :])


def generate_pixels(data_dir: str, number: int = 100, frame_size: int = 64,
                    seed: int = 42) -> None:
    """Draw the fixed observation pixels (``gen_pixels.py``): the same seed
    gives the reference's coordinates."""
    out = os.path.join(data_dir, "pixels")
    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(seed)
    rand_w = rng.randint(frame_size, size=number)
    rand_h = rng.randint(frame_size, size=number)
    np.savez_compressed(os.path.join(out, "pixels.npz"), rand_w=rand_w, rand_h=rand_h)
