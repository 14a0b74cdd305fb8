"""JAX package params -> port state_dict, for mmFormer: the whole tree,
the training-only modules (`decoder_sep`, `fuse_path/decoder_fuse/seg_d*`)
included.

`mmformer_from_jax_params(tree)` takes the flax param tree of
`passion_tpu.models.mmformer.MMFormer` as nested dicts of numpy arrays
(with or without the top-level "params" key) and returns a state_dict for
`passion_tpu_torch.models.mmformer.MMFormer`; `load_jax_npz(path)` does the
same for an .npz of the flattened tree ("params/encoders/e1_c1/Conv_0/kernel"
and so on; the README gives the recipe). The tree is the same for both
`use_s2d` settings of the JAX model (its space-to-depth path declares raw
twins of the same params), so one converter covers both.

Layouts: flax conv kernels (k, k, k, Ci/G, Co) become (Co, Ci/G, k, k, k);
Dense kernels (in, out) become Linear weights (out, in); LayerNorm
scale/bias become weight/bias. `intra_transformers` is stacked on a leading
axis of 4 (one Transformer per modality, nn.vmap with params on axis 0)
and is unstacked here; `fuse_path` params are shared across the vmapped
masks and map one to one.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BLOCK = re.compile(r"(attn_norm|ffn_norm|attn|ffn)_(\d+)")
_RFM_CONV = re.compile(r"GeneralConv3dPreNorm_(\d)")
_DENSE = {"Dense_0": "fc1", "Dense_1": "fc2"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_key(path) -> tuple[str, bool]:
    """(state_dict key, whether the array is a conv/Dense kernel)."""
    *mods, leaf = path
    names = []
    for p in mods:
        if p == "Conv3d_0":  # GeneralConv3dPreNorm's conv child
            names.append("conv")
        elif p == "Conv_0":  # nn.Conv inside the model's Conv3d: folded
            continue
        elif m := _RFM_CONV.fullmatch(p):
            names += ["layers", m[1]]
        elif m := _BLOCK.fullmatch(p):
            names += ["layers", m[2], m[1]]
        else:
            names.append(_DENSE.get(p, p))
    if leaf in ("kernel", "scale"):
        names.append("weight")
    else:  # bias, pos
        names.append(leaf)
    return ".".join(names), leaf == "kernel"


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 5:  # (k, k, k, Ci/G, Co) -> (Co, Ci/G, k, k, k)
        return arr.transpose(4, 3, 0, 1, 2)
    if arr.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return arr.T
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


def mmformer_from_jax_params(params) -> dict[str, torch.Tensor]:
    """State_dict of the port's MMFormer from the JAX MMFormer param tree."""
    if "params" in params and isinstance(params["params"], dict):
        params = params["params"]
    sd = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[0] == "intra_transformers":
            per_modality = [(path[:1] + (str(m),) + path[1:], arr[m])
                            for m in range(arr.shape[0])]
        else:
            per_modality = [(path, arr)]
        for p, a in per_modality:
            key, is_kernel = _port_key(p)
            if is_kernel:
                a = _to_torch_layout(a)
            if key in sd:
                raise ValueError(f"two JAX params map to {key}")
            sd[key] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def load_jax_npz(path: str) -> dict[str, torch.Tensor]:
    """State_dict from an .npz of the JAX package's flattened params
    (keys joined with "/")."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            *mods, leaf = key.split("/")
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
    return mmformer_from_jax_params(tree)
