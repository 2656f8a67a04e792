"""The port's CSVImageDataset (data/csv_dataset.py) against the JAX
package's on tests/test_misc.py's fixture: the same split, order, classes,
images, and the same order after reshuffle()."""

import numpy as np
from PIL import Image

from calm_vit_dte_tpu.data.csv_dataset import (
    CSVImageDataset as JCSVImageDataset,
)
from calm_vit_dte_tpu_torch.data.csv_dataset import CSVImageDataset


def _fixture(root):
    rng = np.random.default_rng(0)
    (root / "imgs").mkdir()
    rows = ["idx,file,label"]
    for i in range(10):
        name = f"imgs/{i}.png"
        Image.fromarray(rng.integers(0, 255, (20, 30, 3),
                                     dtype=np.uint8)).save(root / name)
        rows.append(f"{i},{name},{i % 2}")
    (root / "data.csv").write_text("\n".join(rows))


def test_csv_dataset_matches_jax(tmp_path):
    _fixture(tmp_path)
    for train in (True, False):
        ours = CSVImageDataset(str(tmp_path), "data.csv", size=16,
                               train=train)
        ref = JCSVImageDataset(str(tmp_path), "data.csv", size=16,
                               train=train)
        assert len(ours) == len(ref) == (8 if train else 2)
        assert ours.num_classes == ref.num_classes == 2
        assert ours._view() == ref._view()
        for i in range(len(ref)):
            img, label = ours.load(i)
            want_img, want_label = ref.load(i)
            assert img.shape == (16, 16, 3) and label == want_label
            np.testing.assert_array_equal(img, want_img)
        for _ in range(2):
            before = list(ours._view())
            ours.reshuffle()
            ref.reshuffle()
            assert ours.seed == ref.seed
            assert ours._view() == ref._view()
        if train:
            assert ours._view() != before
