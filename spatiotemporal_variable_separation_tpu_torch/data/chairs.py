"""3D Warehouse Chairs dataset (reference ``var_sep/data/chairs.py``).

The port's own copy of the JAX package's ``data/chairs.py:17-113`` (numpy
and Pillow only, which the port may not import from there).  It reads
``rendered_chairs/<obj>/renders/{i}.png`` sequences (64x64 crops made by
``preprocess_chairs``), shuffles the sorted object list with
``RandomState(42)``, splits it 85/15 into train and test, and serves
``seq_len`` consecutive views with wraparound modulo 62
(``chairs.py:45-60``).  Items are (cond, target) float32 in (T, H, W, 3),
values in [0, 1].
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def read_frame(path: str) -> np.ndarray:
    """A render as a contiguous (H, W, 3) uint8 array (an alpha channel is
    dropped; the copy keeps a cached frame from pinning the RGBA buffer)."""
    from PIL import Image

    return np.ascontiguousarray(np.asarray(Image.open(path))[..., :3])


class Chairs:
    max_length = 62

    def __init__(self, train: bool, data_root: str, nt_cond: int,
                 seq_len: int = 15, image_size: int = 64, cache_frames=False):
        assert seq_len <= self.max_length
        assert image_size == 64
        self.train = train
        self.nt_cond = nt_cond
        self.seq_len = seq_len
        self.image_size = image_size
        # Decoded-frame cache, opt-in and unbounded: consecutive indices
        # cycle over objects, so a full pass decodes each render ~seq_len
        # times without it.  A dict shares one cache between datasets over
        # the same files (the content-swap eval's test and swap sets).
        if isinstance(cache_frames, dict):
            self._frame_cache: Optional[dict] = cache_frames
        else:
            self._frame_cache = {} if cache_frames else None
        self.data_root = os.path.join(data_root, "rendered_chairs")
        sequences = sorted(os.listdir(self.data_root))
        if "all_chair_names.mat" in sequences:
            sequences.remove("all_chair_names.mat")
        rng = np.random.RandomState(42)
        rng.shuffle(sequences)
        self.sequences = sequences
        split = int(len(sequences) * 0.85)
        self.start_idx, self.stop_idx = (0, split) if train else (split, len(sequences))

    def __len__(self) -> int:
        return self.max_length * (self.stop_idx - self.start_idx)

    @property
    def objects(self) -> list:
        """The split's object directories, in index order."""
        return self.sequences[self.start_idx:self.stop_idx]

    def frame_path(self, obj_dir: str, view: int) -> str:
        return os.path.join(self.data_root, obj_dir, "renders", f"{view}.png")

    def get_sequence(self, index: int, chosen_idx: Optional[int] = None,
                     chosen_id_st: Optional[int] = None) -> np.ndarray:
        """(seq_len, H, W, 3) uint8 views: object ``index % n_objects`` (or
        ``chosen_idx``) from view ``index // n_objects`` (or
        ``chosen_id_st``), wrapping modulo 62."""
        index, idx = divmod(index, self.stop_idx - self.start_idx)
        if chosen_idx is not None:
            idx = chosen_idx
        obj_dir = self.sequences[self.start_idx + idx]
        index, id_st = divmod(index, self.max_length)
        if chosen_id_st is not None:
            id_st = chosen_id_st
        assert index == 0

        frames = []
        for i in range(id_st, id_st + self.seq_len):
            i %= self.max_length
            if self._frame_cache is not None:
                frame = self._frame_cache.get((obj_dir, i))
                if frame is None:
                    frame = self._frame_cache[(obj_dir, i)] = read_frame(
                        self.frame_path(obj_dir, i))
            else:
                frame = read_frame(self.frame_path(obj_dir, i))
            frames.append(frame)
        return np.asarray(frames)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        seq = self.get_sequence(index).astype(np.float32) / 255.0  # (T, H, W, 3)
        return seq[: self.nt_cond], seq[self.nt_cond:]


def _is_generated_name(name: str) -> bool:
    stem, ext = os.path.splitext(name)
    return ext == ".png" and stem.isdigit()


def preprocess_chairs(data_dir: str, image_size: int = 64) -> None:
    """Crop (100, 100, 500, 500) and LANCZOS-resize every render in place as
    ``{i}.png`` (reference ``preprocessing/chairs/gen_chairs.py:23-33``).

    As in the JAX package, a second run is harmless: numeric ``{i}.png``
    outputs of an earlier run are not taken as inputs (the reference
    re-crops its own 64x64 outputs into black frames)."""
    from PIL import Image

    root = os.path.join(data_dir, "rendered_chairs")
    folders = [f for f in os.listdir(root) if f != "all_chair_names.mat"]
    for folder in folders:
        renders = os.path.join(root, folder, "renders")
        sources = [f for f in sorted(os.listdir(renders)) if not _is_generated_name(f)]
        for i, image_file in enumerate(sources):
            img = Image.open(os.path.join(renders, image_file))
            img = img.crop((100, 100, 500, 500)).resize(
                (image_size, image_size), resample=Image.LANCZOS)
            img.save(os.path.join(renders, f"{i}.png"))
