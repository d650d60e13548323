"""Synthetic stand-in corpora in the reference's on-disk formats.

The port's own copy of the JAX package's ``data/synthetic_corpora.py`` for
the corpora the port trains on so far: ``make_chairs`` (``:237-271``).  The
3D Warehouse renders cannot be fetched here; the stand-in writes the same
tree (``rendered_chairs/all_chair_names.mat``, which the loader removes,
then ``obj_{i:04d}/renders/{v}.png`` for 62 views of 64x64 RGB), so the
chairs recipe runs end to end.  Scores on it validate the pipeline, not the
paper's numbers.  TaxiBJ, SST and the MNIST stand-in come with their
verticals (``cli/gen_synthetic.py`` names each one's ROADMAP item).
"""

from __future__ import annotations

import os

import numpy as np


def make_chairs(data_dir: str, n_objects: int = 200, seed: int = 0) -> None:
    """62 azimuth renders per object: a shaded rotating box with
    object-specific geometry and colour on a white ground, 64x64 RGB."""
    from PIL import Image, ImageDraw

    rng = np.random.RandomState(seed)
    base = os.path.join(data_dir, "rendered_chairs")
    os.makedirs(base, exist_ok=True)
    open(os.path.join(base, "all_chair_names.mat"), "wb").close()
    for obj in range(n_objects):
        odir = os.path.join(base, f"obj_{obj:04d}", "renders")
        os.makedirs(odir, exist_ok=True)
        w = rng.uniform(10, 22)        # half-width
        h = rng.uniform(14, 26)        # height
        color = tuple(int(c) for c in rng.randint(40, 220, 3))
        leg = rng.uniform(4, 10)
        for i in range(62):
            az = 2 * np.pi * i / 62
            img = Image.new("RGB", (64, 64), (255, 255, 255))
            drw = ImageDraw.Draw(img)
            # box silhouette: the apparent width follows |cos|, the shading
            # the lit face's share -- cheap, but consistent across views
            aw = max(3.0, w * (0.35 + 0.65 * abs(np.cos(az))))
            shade = 0.55 + 0.45 * (np.sin(az) * 0.5 + 0.5)
            fill = tuple(int(c * shade) for c in color)
            cx, top = 32, 32 - h / 2
            drw.rectangle([cx - aw, top, cx + aw, top + h], fill=fill)
            # a seat-back on one side, rotating with the azimuth
            bx = cx + aw * np.sin(az) * 0.6
            drw.rectangle([bx - 2, top - leg, bx + 2, top], fill=fill)
            drw.rectangle([cx - aw, top + h, cx - aw + 3, top + h + leg], fill=(60, 60, 60))
            drw.rectangle([cx + aw - 3, top + h, cx + aw, top + h + leg], fill=(60, 60, 60))
            img.save(os.path.join(odir, f"{i}.png"))
