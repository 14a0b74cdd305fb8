"""BraTS npy datasets (counterpart of `passion_tpu/data/datasets.py`):
`BratsTest` for the sweep, `BratsTrainIDT` and `BratsTrainPDT` for training.

Volumes are stored (H, W, Z, 4) float32 and segmentations (H, W, Z). The
test set hands them on in that layout (the sweep engine moves channels
first on the card); the training sets run the reference's augmentation
pipeline (data/transforms.py) in that layout and return channels-first
x (4, H, W, Z) and one-hot target (num_cls, H, W, Z). Training items draw
their randomness from an explicit `numpy.random.Generator`, in the JAX
package's order, so a given generator gives the same item on both sides.
"""

from __future__ import annotations

import ast
import csv
import os

import numpy as np

from passion_tpu_torch.data import transforms as T
from passion_tpu_torch.masks import MASK_ARRAY

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


def _one_hot(y, num_cls):
    return np.eye(num_cls, dtype=np.float32)[y.astype(np.int64)]


class _BratsTrain:
    """Shared loading and augmentation of the training datasets."""

    def __init__(self, root, names, transforms, modal, num_cls):
        self.root = root
        self.names = names
        self.transform = (T.from_string(transforms or "")
                          if isinstance(transforms, str) or transforms is None
                          else transforms)
        self.modal_ind = np.array(MODAL_INDEX[modal])
        self.num_cls = num_cls

    def __len__(self):
        return len(self.names)

    def _augmented(self, index, rng):
        """(x (4, H, W, Z) float32, target (num_cls, H, W, Z) one-hot)."""
        name = self.names[index]
        x = np.load(os.path.join(self.root, "vol", name + "_vol.npy"))
        y = np.load(os.path.join(self.root, "seg", name + "_seg.npy"))
        x, y = self.transform([x[None].astype(np.float32), y[None]], rng)
        x = x[0][..., self.modal_ind]
        yo = _one_hot(y[0], self.num_cls)
        return (np.ascontiguousarray(np.moveaxis(x, -1, 0)),
                np.ascontiguousarray(np.moveaxis(yo, -1, 0)))


class BratsTrainPDT(_BratsTrain):
    """Partially-different training: a random mask of the 15 per access
    (datasets_nii.py:37-92)."""

    def __init__(self, transforms="", root=None, modal="all", num_cls=4,
                 train_file="train.txt"):
        super().__init__(root, _read_list(os.path.join(root, train_file)),
                         transforms, modal, num_cls)

    def get(self, index, rng):
        x, target = self._augmented(index, rng)
        mask = MASK_ARRAY[int(rng.integers(0, 15))]
        return dict(x=x, target=target, mask=mask.copy(),
                    name=self.names[index])


class BratsTrainIDT(_BratsTrain):
    """Identically- (or drop-) different training driven by the imb-MR CSV
    (datasets_nii.py:94-163). The CSV's row order pairs samples with masks
    and is kept (not sorted)."""

    def __init__(self, transforms="", root=None, modal="all", num_cls=4,
                 mask_type="idt", train_file=None):
        with open(train_file) as f:
            rows = list(csv.DictReader(f))
        super().__init__(root, [r["data_name"] for r in rows], transforms,
                         modal, num_cls)
        self.mask_ids = [int(r["mask_id"]) for r in rows]
        self.pos_mask_ids = [ast.literal_eval(r["pos_mask_ids"])
                             for r in rows]
        self.sample_masks = [ast.literal_eval(r["mask"]) for r in rows]
        self.mask_type = mask_type

    def modal_counts(self):
        """Per-modality present counts over the CSV (train.py:163-168)."""
        return np.array(self.sample_masks, dtype=np.int64).sum(axis=0)

    def get(self, index, rng):
        if self.mask_type == "idt":
            mask_idx = self.mask_ids[index]
        elif self.mask_type == "idt_drop":
            choices = self.pos_mask_ids[index]
            mask_idx = int(choices[int(rng.integers(0, len(choices)))])
        elif self.mask_type == "pdt":
            mask_idx = int(rng.integers(0, 15))
        else:
            raise ValueError(f"bad mask_type {self.mask_type!r}")
        x, target = self._augmented(index, rng)
        return dict(x=x, target=target, mask=MASK_ARRAY[mask_idx].copy(),
                    name=self.names[index])
