"""CSV-driven image dataset with an in-memory train/val split.

JAX counterpart: calm_vit_dte_tpu/data/csv_dataset.py, copied (the port
imports nothing of the JAX package). Reference: ImageDataset
(CALM_ViT_V2.py:86-111) reads a CSV of (index, filename, label) rows for the
"AI_Human_Generated_Images" side project, shuffles once, splits 80/20, loads
PIL images and exposes reshuffle(). As in the JAX package: the shuffle is
seeded (the reference used the global random module), and images are
decoded and resized to a fixed square so batches are uniform.
"""

from __future__ import annotations

import csv
import pathlib

import numpy as np


class CSVImageDataset:
    def __init__(self, root_dir: str, csv_file: str, *, size: int = 256,
                 split_ratio: float = 0.8, train: bool = True,
                 path_col: int = 1, label_col: int = 2, seed: int = 0):
        self.root = pathlib.Path(root_dir)
        self.size = size
        self.train = train
        self.split_ratio = split_ratio
        self.seed = seed
        with open(self.root / csv_file) as f:
            reader = csv.reader(f)
            next(reader)  # header
            self.rows = [(r[path_col], int(r[label_col])) for r in reader]
        self._shuffle(seed)

    def _shuffle(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.rows))
        self.rows = [self.rows[i] for i in order]
        self.split = int(self.split_ratio * len(self.rows))

    def reshuffle(self) -> None:
        self.seed += 1
        self._shuffle(self.seed)

    def _view(self):
        return self.rows[:self.split] if self.train else self.rows[self.split:]

    def __len__(self) -> int:
        return len(self._view())

    @property
    def num_classes(self) -> int:
        return len({label for _, label in self.rows})

    def load(self, idx: int):
        from PIL import Image

        name, label = self._view()[idx]
        with Image.open(self.root / name) as im:
            im = im.convert("RGB").resize((self.size, self.size),
                                          Image.BILINEAR)
            return np.asarray(im, dtype=np.uint8), label
