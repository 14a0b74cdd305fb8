"""The port's import of reference PyTorch checkpoints
(`passion_tpu_torch.interop.torch_weights`) against the JAX package's
(`passion_tpu.interop.torch_weights`), float32 on the CPU, at the widths of
the backbones' parity tests (mmFormer patch 16, basic_dims 4, trans_dim 32,
mlp_dim 64, heads 4; RFNet patch 16, basic_dims 4; M2FTrans patch 32,
basic_dims 2, heads 4, mlp_dim 32, depth 2).

No upstream checkpoint is in the repository, so each backbone's upstream
state_dict is built from the port's table read backwards (upstream shapes
from the port model's), with values from `default_rng` at scale 0.3. Then:
  (a) the JAX converter reads every key of it, and its tree has the keys
      and shapes of `init_params_host`'s: the table's upstream keys are the
      ones the JAX converter reads;
  (b) the port's converter equals the JAX converter followed by
      `from_jax_params`, key for key and bit for bit;
  (c) the port model loaded from (b) gives the JAX model's softmax on all
      15 masks (one batch, a mask per row) at atol 1e-4;
  (d) `load_torch_checkpoint` gives the JAX loader's arrays for a saved
      `{epoch, state_dict with "module.", optim_dict}` and a bare
      state_dict;
  (e) a missing upstream key raises, naming it.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from passion_tpu.interop import torch_weights as jtw
from passion_tpu.masks import MASK_ARRAY
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch.interop import jax_weights
from passion_tpu_torch.interop import torch_weights as ttw
from passion_tpu_torch.models import get_model

torch.set_num_threads(2)
BACKBONES = {
    "mmformer": (16, dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4),
                 dict(depth=1)),
    "rfnet": (16, dict(basic_dims=4), {}),
    "m2ftrans": (32, dict(basic_dims=2, heads=4, mlp_dim=32, depth=2),
                 dict(depth=2)),
}
TABLES = {"mmformer": ttw.mmformer_table, "rfnet": ttw.rfnet_table,
          "m2ftrans": ttw.m2ftrans_table}
PORT = {"mmformer": ttw.mmformer_params_from_torch,
        "rfnet": ttw.rfnet_params_from_torch,
        "m2ftrans": ttw.m2ftrans_params_from_torch}
JAX = {"mmformer": jtw.mmformer_params_from_torch,
       "rfnet": jtw.rfnet_params_from_torch,
       "m2ftrans": jtw.m2ftrans_params_from_torch}


def upstream_state_dict(table, port_sd, rng, scale=0.3):
    """An upstream-format state_dict for `table`, shaped after the port's
    state_dict: a slotted conv row holds a quarter of the port tensor's
    dim 0, a slotted `pos` one slice of it, a ModalFusion Linear a 1x1x1
    conv."""
    shapes = {}
    for up, port, slot in table:
        shape = tuple(port_sd[port].shape)
        if slot is not None:
            shape = ((shape[0] // 4,) + shape[1:]
                     if port.endswith((".weight", ".bias")) else shape[1:])
        elif ".weight_layer." in up and up.endswith(".weight"):
            shape += (1, 1, 1)
        shapes[up] = shape
    return {up: torch.from_numpy((scale * rng.standard_normal(s)).astype(
        np.float32)) for up, s in shapes.items()}


class _Reads(dict):
    """A state_dict that records which keys were read."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


@pytest.fixture(scope="module", params=list(BACKBONES))
def case(request):
    """(name, upstream sd, JAX model, JAX tree, port model loaded from the
    port's converter, port sd, the JAX converter's keys read)."""
    name = request.param
    patch, kw, conv_kw = BACKBONES[name]
    tm = get_model(name, mask_type="idt", patch_size=patch, **kw)
    sd = upstream_state_dict(TABLES[name](**conv_kw), tm.state_dict(),
                             np.random.default_rng(0))
    reads = _Reads(sd)
    tree = JAX[name](reads, **conv_kw)
    port_sd = PORT[name](sd, **conv_kw)
    tm.load_state_dict(port_sd, strict=True)
    jm = jax_get_model(name, mask_type="idt", patch_size=patch, **kw)
    return name, sd, jm, tree, tm.eval(), port_sd, reads.read


def test_jax_converter_reads_the_whole_table(case):
    name, sd, jm, tree, _, _, read = case
    assert read == set(sd)
    patch = BACKBONES[name][0]
    ref = traverse_util.flatten_dict(jax.tree_util.tree_map(
        np.shape, init_params_host(jm, seed=0, patch_size=patch,
                                   batch_size=1)), sep="/")
    got = traverse_util.flatten_dict(jax.tree_util.tree_map(np.shape, tree),
                                     sep="/")
    assert got == ref


def test_port_converter_equals_jax_then_from_jax_params(case):
    name, _, _, tree, tm, port_sd, _ = case
    via_jax = jax_weights.from_jax_params(tree, name)
    assert set(port_sd) == set(via_jax) == set(tm.state_dict())
    for k, v in via_jax.items():
        assert port_sd[k].dtype == torch.float32
        torch.testing.assert_close(port_sd[k], v, rtol=0, atol=0, msg=k)


def test_softmax_matches_jax_on_all_masks(case):
    name, _, jm, tree, tm, _, _ = case
    patch = BACKBONES[name][0]
    x = np.random.default_rng(1037).standard_normal(
        (1, patch, patch, patch, 4)).astype(np.float32)
    x = np.repeat(x, len(MASK_ARRAY), axis=0)
    masks = np.asarray(MASK_ARRAY, bool)
    ref = np.asarray(jax.jit(jm.apply)(tree, x, masks))
    assert np.abs(ref - 0.25).max() > 0.05  # not a uniform softmax
    with torch.no_grad():
        got = tm(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))),
                 torch.from_numpy(masks)).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("wrapped", [True, False])
def test_checkpoint_loader_matches_jax(case, tmp_path, wrapped):
    name, sd, _, _, _, port_sd, _ = case
    path = tmp_path / f"{name}.pth"
    if wrapped:  # the reference's train.py: DataParallel, with optimizer
        torch.save({"epoch": 3, "state_dict": {"module." + k: v
                                               for k, v in sd.items()},
                    "optim_dict": {"state": {}, "param_groups": [
                        {"lr": 2e-4, "betas": (0.9, 0.999), "params": [0]}]}},
                   path)
    else:
        torch.save(sd, path)
    got = ttw.load_torch_checkpoint(str(path))
    want = jtw.load_torch_checkpoint(str(path))
    assert set(got) == set(want) == set(sd)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), want[k])
    again = PORT[name](got, **BACKBONES[name][2])
    for k, v in port_sd.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0, msg=k)


def test_missing_upstream_key_raises(case):
    name, sd, _, _, _, _, _ = case
    # a weight the JAX converter always reads (it skips a missing bias or
    # ffn2)
    weights = [k for k in sorted(sd)
               if k.endswith(".weight") and ".ffn2." not in k]
    gone = weights[len(weights) // 2]
    less = {k: v for k, v in sd.items() if k != gone}
    with pytest.raises(KeyError, match=gone.replace(".", r"\.")):
        PORT[name](less, **BACKBONES[name][2])
    with pytest.raises(KeyError):  # the JAX converter refuses it too
        JAX[name](less, **BACKBONES[name][2])
    # upstream keys outside the table are ignored, as in JAX
    extra = dict(sd, **{"unused.weight": torch.zeros(3)})
    assert set(PORT[name](extra, **BACKBONES[name][2])) == set(
        PORT[name](sd, **BACKBONES[name][2]))
