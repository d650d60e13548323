"""Moving MNIST: ``digits`` (blob digits, 28x28 uint8, made from the seed)
and ``render``, which draws a batch's digit indices, start positions and
velocities from a generator and renders the bouncing digits.  The draws are
made in the order and with the calls that the training step's on-device
generator makes them (a ``randint`` of indices, then of starts, then of
velocities), so the same generator state gives the batch the program trained
on; the render is this file's own: positions by the triangle fold of a
bounce at the walls, digits pasted by index arithmetic, overlaps clipped at
255.

Mix keys: ``digits`` (how many are made), ``num_digits`` (a frame's),
``max_speed``."""

from __future__ import annotations

import torch

from reference.data import derive, generator

DIGIT = 28
FRAME = 64


def digits(seed: int, n: int, device) -> torch.Tensor:
    """``n`` blob digits (n, 28, 28) uint8: 255 at a random centre in
    [8, 20), falling off with the squared distance at a random rate in [2, 6)."""
    gen = generator(derive(seed, "digits"), device)
    centre = torch.randint(8, 20, (n, 2), generator=gen, device=device)
    rate = torch.randint(2, 6, (n, 1, 1), generator=gen, device=device)
    grid = torch.arange(DIGIT, device=device)
    d2 = ((grid[None, :, None] - centre[:, 0, None, None]) ** 2
          + (grid[None, None, :] - centre[:, 1, None, None]) ** 2)
    return (255 - d2 * rate).clamp(0, 255).to(torch.uint8)


def render(gen: torch.Generator, pool: torch.Tensor, batch: int, seq_len: int,
           num_digits: int = 2, max_speed: int = 4) -> torch.Tensor:
    """(batch, seq_len, 64, 64, 1) f32 frames in [0, 1] of ``num_digits``
    digits of ``pool`` bouncing at integer speeds up to ``max_speed``."""
    device = gen.device
    limit = FRAME - DIGIT
    kw = dict(generator=gen, device=device, dtype=torch.int32)
    idx = torch.randint(0, pool.shape[0], (batch, num_digits), generator=gen, device=device)
    start = torch.randint(0, limit + 1, (batch, num_digits, 2), **kw)
    vel = torch.randint(-max_speed, max_speed + 1, (batch, num_digits, 2), **kw)
    t = torch.arange(seq_len, device=device, dtype=torch.int64)
    travel = start[:, :, None, :].long() + vel[:, :, None, :].long() * t[:, None]
    period = travel % (2 * limit)
    pos = torch.where(period > limit, 2 * limit - period, period)  # (B, D, T, 2)
    ar = torch.arange(DIGIT, device=device)
    rows = pos[..., 0, None] + ar                                   # (B, D, T, 28)
    cols = pos[..., 1, None] + ar
    b = torch.arange(batch, device=device)[:, None, None, None, None]
    tt = t[None, None, :, None, None]
    canvas = torch.zeros((batch, seq_len, FRAME, FRAME), dtype=torch.float32, device=device)
    values = pool[idx].float()[:, :, None].expand(-1, -1, seq_len, -1, -1)
    shape = values.shape
    canvas.index_put_((b.expand(shape), tt.expand(shape), rows[..., :, None].expand(shape),
                       cols[..., None, :].expand(shape)), values, accumulate=True)
    scale = torch.tensor(255.0, device=device)
    return (canvas.clamp(0.0, 255.0) / scale)[..., None]


def make(mix: dict, seed: int, device) -> torch.Tensor:
    return digits(seed, mix["digits"], device)


def draw(gen: torch.Generator, made: torch.Tensor, mix: dict, batch: int,
         seq_len: int) -> torch.Tensor:
    return render(gen, made, batch, seq_len, mix["num_digits"], mix["max_speed"])
