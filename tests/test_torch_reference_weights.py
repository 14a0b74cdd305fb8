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
  (e) a missing upstream key raises, naming it;
  (f) `--use_pretrain`'s `load_pretrained_params` takes every port tensor
      of such a file (at the model's own depth, one read of the file) and
      equals the strict load; a checkpoint that matches nothing raises;
  (g) `python -m passion_tpu_torch.eval --resume` reads the file strictly.
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
from passion_tpu_torch import eval as port_eval
from passion_tpu_torch.data.datasets import (TEST_TRANSFORMS, BratsTest,
                                             CaseLoader)
from passion_tpu_torch.data.synth import make_synthetic_dataset
from passion_tpu_torch.engine import checkpoint as ckpt
from passion_tpu_torch.engine.evaluator import run_test_sweep
from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
from passion_tpu_torch.interop import jax_weights
from passion_tpu_torch.interop import torch_weights as ttw
from passion_tpu_torch.models import get_model, init_model

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


def _save_upstream(sd, path):
    """`sd` as the reference's train.py saves it (DataParallel keys)."""
    torch.save({"epoch": 0, "state_dict": {"module." + k: v
                                           for k, v in sd.items()},
                "optim_dict": {}}, path)


def test_use_pretrain_takes_every_tensor(case, tmp_path):
    """`--use_pretrain` on a reference checkpoint: `load_pretrained_params`
    converts it at the model's own depth and takes every port tensor,
    leaving the model equal to the strict load."""
    name, sd, _, _, tm, _, _ = case
    patch, kw, _ = BACKBONES[name]
    path = str(tmp_path / "model_last.pth")
    _save_upstream(sd, path)
    model = init_model(get_model(name, mask_type="idt", patch_size=patch,
                                 **kw), seed=5)
    taken = ckpt.load_pretrained_params(path, model)
    assert taken == sorted(model.state_dict())
    want = tm.state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_reference_checkpoint_is_read_once(case, tmp_path, monkeypatch):
    """`load_weights` converts the blob it has loaded, through the table
    that `params_from_torch` picks by the model's class: one read of the
    file, and the per-backbone converter's tensors."""
    name, sd, _, _, _, port_sd, _ = case
    patch, kw, _ = BACKBONES[name]
    path = str(tmp_path / "model_last.pth")
    _save_upstream(sd, path)
    reads, load = [], torch.load
    monkeypatch.setattr(torch, "load",
                        lambda f, *a, **k: reads.append(f) or load(f, *a, **k))
    got = ckpt.load_weights(path, get_model(name, mask_type="idt",
                                            patch_size=patch, **kw))
    assert reads == [path]
    assert set(got) == set(port_sd)
    for k, v in port_sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_params_from_torch_refuses_a_model_without_a_table():
    with pytest.raises(ValueError, match="Linear"):
        ttw.params_from_torch({}, torch.nn.Linear(2, 2))


@pytest.mark.parametrize("wrapped", [True, False])
def test_use_pretrain_refuses_a_checkpoint_it_cannot_use(tmp_path, wrapped):
    """A checkpoint that shares no key and shape with the model raises,
    naming the file, instead of leaving the seed's weights in place."""
    model = init_model(get_model("rfnet", patch_size=16, basic_dims=4))
    held = {"encoders.e1_c1.conv.weight": torch.zeros(3),  # wrong shape
            "other.weight": torch.zeros(2)}  # not the model's
    path = str(tmp_path / "other.pt")
    ckpt.save_checkpoint(path, {"epoch": 0, "model": held, "optimizer": {}}
                         if wrapped else held)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="other.pt"):
        ckpt.load_pretrained_params(path, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("upstream_eval")
    make_synthetic_dataset(str(root), n_cases=3, shape=(24, 20, 18), seed=2)
    return str(root)


def test_eval_cli_reads_an_upstream_checkpoint(case, tmp_path, eval_data):
    """`python -m passion_tpu_torch.eval --resume model_last.pth` loads a
    reference checkpoint strictly: its CSV equals the sweep of the model
    loaded by hand from the converter."""
    name, sd, _, _, tm, _, _ = case
    patch, kw, _ = BACKBONES[name]
    path = str(tmp_path / "model_last.pth")
    _save_upstream(sd, path)
    out = tmp_path / "out"
    flags = [a for k, v in kw.items() for a in (f"--{k}", str(v))]
    port_eval.main(["--model", name, "--resume", path, "--dataroot",
                    eval_data, "--datapath", ".", "--savepath", str(out),
                    "--patch_size", str(patch), "--device", "cpu", *flags])
    ref = str(tmp_path / "ref.csv")
    run_test_sweep(CaseLoader(BratsTest(TEST_TRANSFORMS, root=eval_data)),
                   SlidingWindowSweep(tm, 4, patch, device="cpu"),
                   csv_name=ref)
    with open(out / f"{name}.csv", "rb") as a, open(ref, "rb") as b:
        got = a.read()
        assert got == b.read()
    assert got.count(b"\n") == 1 + 15 * 2  # header + 15 x (name, 1 case)


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
