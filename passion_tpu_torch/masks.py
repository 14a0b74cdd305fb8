"""Modality-combination mask tables (copy of `passion_tpu/masks.py:14-87`).

Four MRI modalities in fixed index order FLAIR, T1ce, T1, T2. A boolean
length-4 mask selects which modalities are present; the 15 non-empty
combinations are enumerated in the reference's canonical order.
"""

from __future__ import annotations

import numpy as np

MODALITIES = ("flair", "t1ce", "t1", "t2")
NUM_MODALS = 4

MASK_ARRAY = np.array(
    [
        [False, False, False, True],
        [False, True, False, False],
        [False, False, True, False],
        [True, False, False, False],
        [False, True, False, True],
        [False, True, True, False],
        [True, False, True, False],
        [False, False, True, True],
        [True, False, False, True],
        [True, True, False, False],
        [True, True, True, False],
        [True, False, True, True],
        [True, True, False, True],
        [False, True, True, True],
        [True, True, True, True],
    ],
    dtype=bool,
)

MASK_NAMES = (
    "t2", "t1c", "t1", "flair",
    "t1cet2", "t1cet1", "flairt1", "t1t2", "flairt2", "flairt1ce",
    "flairt1cet1", "flairt1t2", "flairt1cet2", "t1cet1t2",
    "flairt1cet1t2",
)

# the fixed validation subset (datasets_nii.py:31-34) that `BratsVal` draws
# its item's mask from
MASK_VALID_ARRAY = np.array(
    [
        [False, False, True, False],
        [False, True, True, False],
        [True, True, False, True],
        [True, True, True, True],
    ],
    dtype=bool,
)


def mask_id_of(mask) -> int:
    """Return the canonical mask_id (row index in MASK_ARRAY) of a mask."""
    mask = np.asarray(mask, dtype=bool)
    hits = np.nonzero((MASK_ARRAY == mask[None, :]).all(axis=1))[0]
    if hits.size != 1:
        raise ValueError(f"not a valid non-empty modality mask: {mask}")
    return int(hits[0])


def sub_combination_ids(mask) -> list[int]:
    """All mask_ids whose present set is a non-empty subset of `mask`: the
    `pos_mask_ids` column of the imb-MR CSVs (generate_imb_mr.py:220-279),
    the combinations a sample may be dropped to under `idt_drop`."""
    mask = np.asarray(mask, dtype=bool)
    return [i for i, row in enumerate(MASK_ARRAY) if not np.any(row & ~mask)]
