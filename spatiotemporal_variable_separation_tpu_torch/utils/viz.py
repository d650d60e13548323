"""Sequence-strip rendering: filmstrip PNGs of eval archives.

The port's own copy of the JAX package's ``utils/viz.py``.  The reference
archives raw uint8 arrays (``test/mnist/test.py:162-168``) and leaves
viewing them to the reader; this renders those archives, or any (T, H, W, C)
sequences, into labelled grids: a row a sequence role (conditioning, ground
truth, prediction, content swap), a column a frame.  NumPy and Pillow only,
no display needed; the pixels equal the JAX package's for the same arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _to_uint8_frames(seq: np.ndarray) -> np.ndarray:
    """(T, H, W, C) any dtype -> (T, H, W, 3) uint8.

    Floats are min-max scaled over the whole sequence (robust for
    physical fields like SST/WaveEq); uint8 passes through.  C=1 is
    broadcast to gray RGB; C=2 (TaxiBJ in/out flows) renders side by
    side; C=3 passes through; other C tile horizontally."""
    seq = np.asarray(seq)
    if seq.ndim == 3:  # (T, H, W)
        seq = seq[..., None]
    if seq.dtype != np.uint8:
        lo, hi = float(seq.min()), float(seq.max())
        seq = ((seq - lo) / (hi - lo + 1e-12) * 255.0).astype(np.uint8)
    t, h, w, c = seq.shape
    if c == 1:
        return np.repeat(seq, 3, axis=-1)
    if c == 3:
        return seq
    # channels side by side within each frame
    panels = [np.repeat(seq[..., i:i + 1], 3, axis=-1) for i in range(c)]
    return np.concatenate(panels, axis=2)


def strip(rows: Dict[str, np.ndarray], max_t: Optional[int] = None,
          pad: int = 2, label_px: int = 8) -> np.ndarray:
    """Compose labeled rows of frames into one (H_total, W_total, 3) uint8.

    ``rows``: ordered mapping label -> (T, H, W, C).  Shorter rows (e.g. a
    5-frame conditioning window next to a 95-frame rollout) are left-
    aligned and padded with dark gray.  A ``label_px``-wide left gutter
    carries a per-row intensity tag rather than text (no font deps)."""
    rendered = {k: _to_uint8_frames(v) for k, v in rows.items()}
    t_max = max(v.shape[0] for v in rendered.values())
    if max_t is not None:
        t_max = min(t_max, max_t)
    h = max(v.shape[1] for v in rendered.values())
    w = max(v.shape[2] for v in rendered.values())
    n_rows = len(rendered)
    grid_h = n_rows * h + (n_rows + 1) * pad
    grid_w = label_px + t_max * w + (t_max + 1) * pad
    canvas = np.full((grid_h, grid_w, 3), 32, np.uint8)
    shades = np.linspace(230, 90, max(n_rows, 2)).astype(np.uint8)
    for r, (label, seq) in enumerate(rendered.items()):
        y = pad + r * (h + pad)
        canvas[y:y + h, :label_px] = shades[r % len(shades)]
        for t in range(min(seq.shape[0], t_max)):
            x = label_px + pad + t * (w + pad)
            fh, fw = seq.shape[1], seq.shape[2]
            canvas[y:y + fh, x:x + fw] = seq[t, :, :min(fw, w)]
    return canvas


def save_strip(path: str, rows: Dict[str, np.ndarray],
               max_t: Optional[int] = None, scale: int = 1) -> None:
    """Render :func:`strip` and write a PNG (``scale`` up-samples 2x/3x
    with nearest neighbor for small frames)."""
    from PIL import Image

    img = strip(rows, max_t=max_t)
    if scale > 1:
        img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
    Image.fromarray(img).save(path)
