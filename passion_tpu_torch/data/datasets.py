"""BraTS npy datasets (counterpart of `passion_tpu/data/datasets.py`):
`BratsTest` for the sweep, `BratsTrainIDT` and `BratsTrainPDT` for
training, `BratsVal` for validation.

Volumes are stored (H, W, Z, 4) float32 and segmentations (H, W, Z). Every
set runs its transform pipeline (data/transforms.py) in that layout. The
test set hands the volume on in it (the sweep engine moves channels first
on the card); the training and validation sets return channels-first
x (4, H, W, Z) and one-hot target (num_cls, H, W, Z). Items draw their
randomness from an explicit `numpy.random.Generator`, in the JAX package's
order, so a given generator gives the same item on both sides.
"""

from __future__ import annotations

import ast
import csv
import os

import numpy as np

from passion_tpu_torch.data import transforms as T
from passion_tpu_torch.masks import MASK_ARRAY, MASK_VALID_ARRAY

TEST_TRANSFORMS = "Compose([NumpyType((np.float32, np.int64)),])"
MODAL_INDEX = {"flair": [0], "t1ce": [1], "t1": [2], "t2": [3],
               "all": [0, 1, 2, 3]}


def _read_list(path):
    with open(path) as f:
        names = [line.strip() for line in f if line.strip()]
    names.sort()
    return names


def _one_hot(y, num_cls):
    return np.eye(num_cls, dtype=np.float32)[y.astype(np.int64)]


class _BratsBase:
    """Loading and the transform pipeline shared by every set."""

    def __init__(self, root, names, transforms, modal):
        self.root = root
        self.names = names
        self.transform = (T.from_string(transforms or "")
                          if isinstance(transforms, str) or transforms is None
                          else transforms)
        self.modal_ind = np.array(MODAL_INDEX[modal])

    def __len__(self):
        return len(self.names)

    def _load(self, index):
        """((1, H, W, Z, 4) float32 volume, (1, H, W, Z) segmentation), the
        pipeline's input."""
        name = self.names[index]
        x = np.load(os.path.join(self.root, "vol", name + "_vol.npy"))
        y = np.load(os.path.join(self.root, "seg", name + "_seg.npy"))
        return x[None].astype(np.float32), y[None]


class BratsTest(_BratsBase):
    """Full uncropped volumes + integer labels (datasets_nii.py:165-208).
    `get` runs the pipeline with `default_rng(0)` unless given a
    generator, as the JAX package's `BratsTest` does; labels enter it as
    uint8."""

    def __init__(self, transforms=TEST_TRANSFORMS, root=None, modal="all",
                 test_file="test.txt"):
        super().__init__(root, _read_list(os.path.join(root, test_file)),
                         transforms, modal)

    def get(self, index, rng=None):
        x, y = self._load(index)
        x, y = self.transform([x, y.astype(np.uint8)],
                              rng or np.random.default_rng(0))
        return dict(x=x[0][..., self.modal_ind], target=y[0],
                    name=self.names[index])


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


class _BratsTrain(_BratsBase):
    """Training-set items: channels-first x and a one-hot target."""

    def __init__(self, root, names, transforms, modal, num_cls):
        super().__init__(root, names, transforms, modal)
        self.num_cls = num_cls

    def _augmented(self, index, rng):
        """(x (4, H, W, Z) float32, target (num_cls, H, W, Z) one-hot)."""
        x, y = self.transform(list(self._load(index)), rng)
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


class BratsVal(_BratsTrain):
    """Validation crops, each under one mask of the fixed 4-mask subset
    `MASK_VALID_ARRAY` drawn after the augmentation
    (datasets_nii.py:211-266)."""

    def __init__(self, transforms="", root=None, modal="all", num_cls=4,
                 train_file="val.txt"):
        super().__init__(root, _read_list(os.path.join(root, train_file)),
                         transforms, modal, num_cls)

    def get(self, index, rng):
        x, target = self._augmented(index, rng)
        mask = MASK_VALID_ARRAY[int(rng.integers(0, 4))]
        return dict(x=x, target=target, mask=mask.copy(),
                    name=self.names[index])
