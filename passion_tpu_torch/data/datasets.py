"""BraTS npy test data (counterpart of `BratsTest` in
`passion_tpu/data/datasets.py`).

Volumes are stored (H, W, Z, 4) float32 and segmentations (H, W, Z); the
engine takes them in that layout and moves channels first on the card.
Only the default test transform (a dtype cast) is ported; the training
datasets and augmentations come with the training slice.
"""

from __future__ import annotations

import os

import numpy as np

TEST_TRANSFORMS = "Compose([NumpyType((np.float32, np.int64)),])"
MODAL_INDEX = {"flair": [0], "t1ce": [1], "t1": [2], "t2": [3],
               "all": [0, 1, 2, 3]}


def _read_list(path):
    with open(path) as f:
        names = [line.strip() for line in f if line.strip()]
    names.sort()
    return names


class BratsTest:
    """Full uncropped volumes + integer labels (datasets_nii.py:165-208).

    `transforms` is "" (no cast) or the reference's default test pipeline
    `TEST_TRANSFORMS` (x float32, labels int64)."""

    def __init__(self, transforms=TEST_TRANSFORMS, root=None, modal="all",
                 test_file="test.txt"):
        if transforms not in ("", TEST_TRANSFORMS):
            raise NotImplementedError(
                f"test transform {transforms!r} is not ported; only "
                f"{TEST_TRANSFORMS!r} is")
        self.cast = transforms == TEST_TRANSFORMS
        self.root = root
        self.names = _read_list(os.path.join(root, test_file))
        self.modal_ind = np.array(MODAL_INDEX[modal])

    def __len__(self):
        return len(self.names)

    def get(self, index):
        name = self.names[index]
        x = np.load(os.path.join(self.root, "vol", name + "_vol.npy"))
        y = np.load(os.path.join(self.root, "seg", name + "_seg.npy"))
        y = y.astype(np.uint8)
        if self.cast:
            x, y = x.astype(np.float32), y.astype(np.int64)
        return dict(x=x[..., self.modal_ind], target=y, name=name)


class CaseLoader:
    """Batches of one case, in the layout `run_test_sweep` reads."""

    def __init__(self, dataset: BratsTest):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            item = self.dataset.get(i)
            yield dict(x=item["x"][None], target=item["target"][None],
                       name=[item["name"]])
