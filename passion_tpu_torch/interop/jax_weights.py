"""JAX package params -> port state_dict, for the three backbones: the whole
tree, the training-only modules (`decoder_sep`, the deep-supervision heads)
included.

`mmformer_from_jax_params(tree)`, `rfnet_from_jax_params(tree)` and
`m2ftrans_from_jax_params(tree)` take the flax param tree of the matching
`passion_tpu.models` backbone as nested dicts of numpy arrays (with or
without the top-level "params" key) and return a state_dict for the port's
model; `load_jax_npz(path, model)` does the same for an .npz of the
flattened tree ("params/encoders/e1_c1/Conv_0/kernel" and so on; the README
gives the recipe). A tree is the same for both `use_s2d` settings of a JAX
model (its space-to-depth path declares raw twins of the same params), so
one converter covers both.

Layouts: flax conv kernels (k, k, k, Ci/G, Co) become (Co, Ci/G, k, k, k);
Dense kernels (in, out) become Linear weights (out, in); LayerNorm
scale/bias become weight/bias. mmFormer's `intra_transformers` is stacked
on a leading axis of 4 (one Transformer per modality, nn.vmap with params
on axis 0) and is unstacked here; vmapped fuse paths share their params
and map one to one.

Names: flax auto-names children by class (`Conv3d_0`, `GeneralConv3d_2`,
`Dense_1`, `LayerNorm_0`, ...). Each such name maps by a fixed rule to the
port's attribute, and a name no rule knows raises, as does a key that two
JAX params would take:
  * `Conv3d_0` (the conv of a conv unit, or a bare conv head) -> `conv`;
  * `Conv_0` alone under a port `Conv3d` -> folded into it;
  * `GeneralConv3dPreNorm_N`, `GeneralConv3d_N` -> `layers.N`;
  * `attn_N`, `attn_norm_N`, `ffn_N`, `ffn_norm_N` -> `layers.N.<name>`;
  * `Dense_0`, `Dense_1` -> `fc1`, `fc2` (FeedForward, ModalFusion);
  * `Conv_N`, `LayerNorm_N` beside each other (M2FTrans's LayerNorm conv
    blocks) -> `convs.N`, `norms.N`.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BLOCK = re.compile(r"(attn_norm|ffn_norm|attn|ffn)_(\d+)")
_UNIT = re.compile(r"(?:GeneralConv3dPreNorm|GeneralConv3d)_(\d+)")
_LN_BLOCK = re.compile(r"(Conv|LayerNorm)_(\d+)")
_AUTO = re.compile(r"[A-Z]\w*_\d+")  # a flax auto-name
_DENSE = {"Dense_0": "fc1", "Dense_1": "fc2"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "pos": "pos", "fusion": "fusion"}
# each backbone's top-level modules and params, to catch a tree handed to
# the wrong converter
_TOP = {
    "mmformer": {"decoder_sep", "encode_convs", "encoders", "fuse_path",
                 "intra_transformers", "pos"},
    "rfnet": {"decoder_fuse", "decoder_sep", "encoders"},
    "m2ftrans": {"decoder_sep", "encoders", "fuse_path", "fusion", "pos"},
}


def _flatten(tree, prefix=(), beside=frozenset()):
    """(path, leaf, names beside the leaf's module) for every leaf."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,), frozenset(tree))
        else:
            yield prefix + (k,), v, beside


def _port_key(path, beside: frozenset) -> tuple[str, bool]:
    """(state_dict key, whether the array is a conv/Dense kernel).
    `beside`: the names beside the module that holds the leaf."""
    *mods, leaf = path
    ln_block = "LayerNorm_0" in beside
    names = []
    for i, p in enumerate(mods):
        if p == "Conv3d_0":
            names.append("conv")
        elif p == "Conv_0" and not (ln_block and i == len(mods) - 1):
            continue
        elif (m := _LN_BLOCK.fullmatch(p)) and ln_block and \
                i == len(mods) - 1:
            names += ["convs" if m[1] == "Conv" else "norms", m[2]]
        elif m := _UNIT.fullmatch(p):
            names += ["layers", m[1]]
        elif m := _BLOCK.fullmatch(p):
            names += ["layers", m[2], m[1]]
        elif p in _DENSE:
            names.append(_DENSE[p])
        elif _AUTO.fullmatch(p):
            raise ValueError(f"no port module for JAX name {p!r} in "
                             f"{'/'.join(path)}")
        else:
            names.append(p)
    if leaf not in _LEAVES:
        raise ValueError(f"no port param for JAX leaf {'/'.join(path)}")
    names.append(_LEAVES[leaf])
    return ".".join(names), leaf == "kernel"


def _to_torch_layout(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 5:  # (k, k, k, Ci/G, Co) -> (Co, Ci/G, k, k, k)
        return arr.transpose(4, 3, 0, 1, 2)
    if arr.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return arr.T
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


def from_jax_params(params, model: str | None = None
                    ) -> dict[str, torch.Tensor]:
    """State_dict of a port module from the matching JAX param tree. With
    `model` ("rfnet", "mmformer", "m2ftrans") the tree must be that whole
    backbone's; without, any module's tree converts."""
    if model is not None and model not in _TOP:
        raise ValueError(f"unknown model: {model!r} (rfnet | mmformer | "
                         f"m2ftrans)")
    if "params" in params and isinstance(params["params"], dict):
        params = params["params"]
    if model is not None and set(params) != _TOP[model]:
        raise ValueError(f"not a JAX {model} param tree: top-level "
                         f"{sorted(params)}, expected {sorted(_TOP[model])}")
    sd = {}
    for path, leaf, beside in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if path[0] == "intra_transformers":
            per_modality = [(path[:1] + (str(m),) + path[1:], arr[m])
                            for m in range(arr.shape[0])]
        else:
            per_modality = [(path, arr)]
        for p, a in per_modality:
            key, is_kernel = _port_key(p, beside)
            if is_kernel:
                a = _to_torch_layout(a)
            if key in sd:
                raise ValueError(f"two JAX params map to {key}")
            sd[key] = torch.from_numpy(np.array(a, order="C"))
    return sd


def mmformer_from_jax_params(params) -> dict[str, torch.Tensor]:
    """State_dict of the port's MMFormer from the JAX MMFormer param tree,
    or of one of its modules from that module's tree."""
    return from_jax_params(params)


def rfnet_from_jax_params(params) -> dict[str, torch.Tensor]:
    """State_dict of the port's RFNet from the JAX RFNet param tree."""
    return from_jax_params(params, "rfnet")


def m2ftrans_from_jax_params(params) -> dict[str, torch.Tensor]:
    """State_dict of the port's M2FTrans from the JAX M2FTrans param tree."""
    return from_jax_params(params, "m2ftrans")


def load_jax_npz(path: str, model: str = "mmformer") -> dict[str, torch.Tensor]:
    """State_dict of the port's `model` from an .npz of the JAX package's
    flattened params (keys joined with "/")."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            *mods, leaf = key.split("/")
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = z[key]
    return from_jax_params(tree, model)
