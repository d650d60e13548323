"""Moving MNIST made on the card.

Torch counterpart of the JAX package's ``data/mnist_device.py`` (reference
host generator ``var_sep/data/moving_mnist.py:112-129``).  The host never
touches a batch:

* trajectories: deterministic bouncing is a *triangle fold*, position
  ``M - |((s0 + d t) mod 2M) - M|`` with M = frame - digit, one closed-form
  expression over the whole (batch, digit, time) tensor; stochastic
  bouncing (speeds redrawn at each wall hit) is the bounded-bounce solver
  with a reflective fold for the rare unresolved tail;
* compositing: a digit at (x, y) is pasted as ``P_row @ digit @ P_col^T``
  with one-hot placement matrices, in f32.  Every product and sum is of
  integers up to 255 per digit, exact in f32, so the frames are bitwise
  those of the JAX package and of the host ``composite``;
* digits are uploaded to the device once, as uint8.

Sampling is split into ``draw`` (digit indices, start positions,
velocities and the bounce speed draws, from a ``torch.Generator`` on the
data's device) and ``render`` (everything after the draws), so the same
draws can be rendered on another device or handed to the JAX functions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spatiotemporal_variable_separation_tpu_torch.core.device import resolve_device

_EPS = 1e-8
# Bounce-resolution bound per timestep: each iteration is a no-op once the
# position is in bounds, so the bound only matters for corner chains where
# redraws keep re-exiting (about 1e-4 of steps need more than 2 iterations
# at max_speed=4).  Steps still unresolved after it are folded back.
MAX_BOUNCES_PER_STEP = 8


def fold_positions(s0: torch.Tensor, d: torch.Tensor, seq_len: int,
                   limit: int) -> torch.Tensor:
    """Closed-form bouncing positions.

    ``s0``/``d``: int32 (..., 2) start and speed; returns (..., seq_len, 2)
    int32 positions in [0, limit], the reference's
    record-after-collision-then-advance loop."""
    t = torch.arange(seq_len, dtype=torch.int32, device=s0.device)
    z = s0[..., None, :] + d[..., None, :] * t[:, None]
    zm = torch.remainder(z, 2 * limit)  # Python mod semantics, as jnp.mod
    return limit - (zm - limit).abs()


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add rounds it: the
    f64 product of two f32 values is exact, so only the sum is rounded
    (twice, f64 then f32, which differs from one rounding only on exact
    f32 ties)."""
    return (a.double() * b + c.double()).float()


def _resolve_bounce(sx, sy, dx, dy, new_speed, limit: int):
    """One bounce-resolution iteration over all trajectories (the JAX
    package's ``_resolve_bounce``, reference ``moving_mnist.py:201-251``):
    find the first crossed border retroactively, swap in the pre-drawn
    replacement speed with signs away from the touched border(s), and replay
    the rest of the step.  A no-op where the position is in bounds.

    ``sx, sy, dx, dy``: (N,) f32; ``new_speed``: (N, 2) int32.  The
    operations are the JAX version's, in f32, with each product-then-sum
    rounded once (``_fma``) as XLA's fused multiply-adds round it.  With
    two roundings a line through a corner can miss both borders by an ulp:
    the trajectory then stays out of bounds until the bounce bound."""
    m = float(np.float32(limit))
    hi = float(np.float32(limit) + np.float32(_EPS))  # f32 (m + eps)
    left, up = sx < -_EPS, sy < -_EPS
    right, bottom = sx > hi, sy > hi
    oob = left | right | up | bottom

    dx0, dy0 = dx == 0, dy == 0
    one = torch.ones_like(dx)
    # general case: intersect the motion line with each flagged border and
    # keep the LAST valid candidate in host order (left, right, up, bottom).
    a = dy / torch.where(dx0, one, dx)
    b = _fma(-a, sx, sy)

    def within(v):
        return (v >= -_EPS) & (v <= hi)

    a_m_b = _fma(a, m, b)
    a_safe = torch.where(dy0, one, a)
    x_up = -b / a_safe
    x_bottom = (m - b) / a_safe
    vleft = left & within(b)
    vright = right & within(a_m_b)
    vup = up & within(x_up)
    vbottom = bottom & within(x_bottom)
    zero, full = torch.zeros_like(sx), torch.full_like(sx, m)
    cx = torch.where(vleft, zero, sx)
    cy = torch.where(vleft, b, sy)
    cx = torch.where(vright, full, cx)
    cy = torch.where(vright, a_m_b, cy)
    cx = torch.where(vup, x_up, cx)
    cy = torch.where(vup, zero, cy)
    cx = torch.where(vbottom, x_bottom, cx)
    cy = torch.where(vbottom, full, cy)
    # axis-aligned special cases keep the original flags (host behaviour)
    cx = torch.where(dx0, sx, cx)
    cy = torch.where(dx0, torch.where(up, zero, full), cy)
    dy0_only = dy0 & ~dx0
    cx = torch.where(dy0_only, torch.where(left, zero, full), cx)
    cy = torch.where(dy0_only, sy, cy)
    axis = dx0 | dy0
    fleft = torch.where(axis, left, vleft)
    fright = torch.where(axis, right, vright)
    fup = torch.where(axis, up, vup)
    fbottom = torch.where(axis, bottom, vbottom)

    p = torch.where(dx0, (sy - cy) / torch.where(dy0, one, dy),
                    (sx - cx) / torch.where(dx0, one, dx))
    ndx = new_speed[:, 0].to(torch.float32)
    ndy = new_speed[:, 1].to(torch.float32)
    ndx = torch.where(fleft, ndx.abs(), ndx)
    ndx = torch.where(fright, -ndx.abs(), ndx)
    ndy = torch.where(fup, ndy.abs(), ndy)
    ndy = torch.where(fbottom, -ndy.abs(), ndy)
    return (torch.where(oob, _fma(ndx, p, cx), sx), torch.where(oob, _fma(ndy, p, cy), sy),
            torch.where(oob, ndx, dx), torch.where(oob, ndy, dy), oob)


def stochastic_positions(s0: torch.Tensor, d0: torch.Tensor, speed_draws: torch.Tensor,
                         limit: int, return_counts: bool = False):
    """Stochastic bouncing positions (the JAX package's scanned solver).

    ``s0``/``d0``: (..., 2) int start/speed; ``speed_draws``:
    (..., seq_len, MAX_BOUNCES_PER_STEP, 2) int32 pre-drawn replacement
    speeds (unused draws are discarded).  Returns (..., seq_len, 2) int32
    rounded positions, recorded then advanced as the host solver does
    (``moving_mnist.py:_stochastic_trajectory``).  ``return_counts`` also
    returns the (..., seq_len) int32 bounces of each step (the draws it
    consumed), with which a test replays the stream through the host solver.
    """
    batch_shape = s0.shape[:-1]
    seq_len = speed_draws.shape[-3]
    s = s0.reshape(-1, 2).to(torch.float32)
    d = d0.reshape(-1, 2).to(torch.float32)
    sx, sy, dx, dy = s[:, 0], s[:, 1], d[:, 0], d[:, 1]
    draws = speed_draws.reshape(-1, seq_len, MAX_BOUNCES_PER_STEP, 2)
    m = float(np.float32(limit))
    hi = float(np.float32(limit) + np.float32(_EPS))
    two_m = torch.tensor(2.0 * m, dtype=torch.float32, device=s.device)
    positions, counts = [], []
    for t in range(seq_len):
        n = torch.zeros(sx.shape, dtype=torch.int32, device=sx.device)
        for i in range(MAX_BOUNCES_PER_STEP):
            sx, sy, dx, dy, bounced = _resolve_bounce(sx, sy, dx, dy, draws[:, t, i], limit)
            n = n + bounced.to(torch.int32)
        # tail fallback: a position still out of bounds after the bound is
        # folded back by plain reflection, its speed pointed inward.
        folded_pos, folded_speed = [], []
        for sc, dc in ((sx, dx), (sy, dy)):
            oob = (sc < -_EPS) | (sc > hi)
            folded = m - (torch.remainder(sc, two_m) - m).abs()
            folded_pos.append(torch.where(oob, folded, sc))
            folded_speed.append(torch.where(oob & (folded < m / 2), dc.abs(),
                                            torch.where(oob, -dc.abs(), dc)))
        sx, sy = folded_pos
        dx, dy = folded_speed
        positions.append(torch.stack([sx, sy], dim=-1).round().to(torch.int32))
        counts.append(n)
        sx, sy = sx + dx, sy + dy
    pos = torch.stack(positions, dim=1).reshape(*batch_shape, seq_len, 2)
    if return_counts:
        return pos, torch.stack(counts, dim=1).reshape(*batch_shape, seq_len)
    return pos


def render_frames(positions: torch.Tensor, digits: torch.Tensor,
                  frame_size: int = 64) -> torch.Tensor:
    """Paste digits at integer positions with one-hot products.

    ``positions``: (B, D, T, 2) int; ``digits``: (B, D, h, w) uint8 or
    float with integer values.  Returns (B, T, frame, frame, 1) f32 in
    [0, 1], overlaps clipped at 255 (reference ``moving_mnist.py:127-128``).
    """
    dev = positions.device
    ds = digits.shape[-1]
    rows = torch.arange(frame_size, dtype=positions.dtype, device=dev)
    offs = torch.arange(ds, dtype=positions.dtype, device=dev)
    # P[b,d,t,r,i] = (r == pos + i): one-hot placement of digit row/col i.
    p_row = (rows[:, None] == positions[..., 0, None, None] + offs).to(torch.float32)
    p_col = (rows[:, None] == positions[..., 1, None, None] + offs).to(torch.float32)
    tmp = torch.matmul(p_row, digits.to(torch.float32)[:, :, None])  # (B,D,T,F,ds)
    frames = torch.einsum("bdtrj,bdtcj->btrc", tmp, p_col)
    # Divide by a tensor on the same device: CUDA divides by a host scalar
    # as a product with its reciprocal, which rounds differently.
    scale = torch.tensor(255.0, dtype=torch.float32, device=dev)
    return (frames.clamp(0.0, 255.0) / scale)[..., None]


class Draws(NamedTuple):
    """The random part of one batch: digit indices (B, D) int64, start
    positions and velocities (B, D, 2) int32, and for stochastic dynamics
    the bounce speed draws (B, D, T, MAX_BOUNCES_PER_STEP, 2) int32."""

    idx: torch.Tensor
    s0: torch.Tensor
    vel: torch.Tensor
    bounce: Optional[torch.Tensor]

    def to(self, device) -> "Draws":
        return Draws(*(None if x is None else x.to(device) for x in self))


class DeviceMovingMNIST:
    """Moving MNIST batches made on one device.

    Deterministic dynamics use the closed-form fold; stochastic ones
    (``deterministic=False``: speeds redrawn at each wall hit, reference
    ``moving_mnist.py:172-253``) use the bounded-bounce solver.  The device
    is the card unless the caller asks for the CPU."""

    train_length = 200_000

    def __init__(self, digit_images: np.ndarray, nt_cond: int, seq_len: int,
                 num_digits: int = 2, frame_size: int = 64, max_speed: int = 4,
                 deterministic: bool = True, device=None):
        device = resolve_device(device, "DeviceMovingMNIST")
        self.data = torch.from_numpy(np.array(digit_images, np.uint8)).to(device)
        self.nt_cond = nt_cond
        self.seq_len = seq_len
        self.num_digits = num_digits
        self.frame_size = frame_size
        self.max_speed = max_speed
        self.deterministic = deterministic
        self.digit_size = int(digit_images.shape[-1])

    def __len__(self) -> int:
        return self.train_length

    @property
    def device(self) -> torch.device:
        return self.data.device

    def draw(self, generator: torch.Generator, batch: int) -> Draws:
        """Draw one batch's random part on the generator's device."""
        kw = dict(generator=generator, device=generator.device, dtype=torch.int32)
        limit, v = self.frame_size - self.digit_size, self.max_speed
        d, n = self.num_digits, self.data.shape[0]
        idx = torch.randint(0, n, (batch, d), generator=generator, device=generator.device)
        s0 = torch.randint(0, limit + 1, (batch, d, 2), **kw)
        vel = torch.randint(-v, v + 1, (batch, d, 2), **kw)
        bounce = None if self.deterministic else torch.randint(
            -v, v + 1, (batch, d, self.seq_len, MAX_BOUNCES_PER_STEP, 2), **kw)
        return Draws(idx, s0, vel, bounce)

    def render(self, data: torch.Tensor, draws: Draws) -> torch.Tensor:
        """(B, T, frame, frame, 1) f32 video from the corpus ``data`` (on the
        draws' device) and the draws."""
        limit = self.frame_size - self.digit_size
        if draws.bounce is None:
            pos = fold_positions(draws.s0, draws.vel, self.seq_len, limit)
        else:
            pos = stochastic_positions(draws.s0, draws.vel, draws.bounce, limit)
        return render_frames(pos, data[draws.idx], self.frame_size)

    def generate_device_batch(self, generator: torch.Generator, batch: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        video = self.render(self.data, self.draw(generator, batch))
        return video[:, : self.nt_cond], video[:, self.nt_cond:]

    @classmethod
    def from_data_dir(cls, data_dir: str, nt_cond: int, seq_len: int,
                      num_digits: int = 2, **kw) -> "DeviceMovingMNIST":
        """The MNIST training digits of ``data_dir`` (idx files, see
        ``moving_mnist.load_mnist``) as a generator."""
        from spatiotemporal_variable_separation_tpu_torch.data.moving_mnist import load_mnist

        digits, _ = load_mnist(data_dir, train=True, require_labels=False)
        return cls(digits, nt_cond, seq_len, num_digits, **kw)
