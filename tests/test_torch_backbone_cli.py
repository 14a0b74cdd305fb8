"""`python -m passion_tpu_torch.train` and `.eval` with `--model rfnet` and
`--model m2ftrans` on the CPU at small widths (patch 16; RFNet basic_dims
4, M2FTrans basic_dims 2, heads 4, mlp_dim 32, depth 2) on synthetic cases:
one epoch of two iterations, the final 15-mask CSV named after the model,
`--resume` continuing at the next epoch, the eval CLI reading the
checkpoint, and each backbone given only the width flags it has."""

import os

import pytest
import torch

from passion_tpu_torch import eval as port_eval
from passion_tpu_torch import train as port_train
from passion_tpu_torch.config import parse_config, parse_train_config
from passion_tpu_torch.data.synth import make_synthetic_dataset
from passion_tpu_torch.engine import checkpoint as ckpt

torch.set_num_threads(2)
WIDTHS = {"rfnet": ["--basic_dims", "4"],
          "m2ftrans": ["--basic_dims", "2", "--heads", "4", "--mlp_dim", "32",
                       "--depth", "2"]}
# flags a backbone does not have, given on purpose: they must be dropped
FOREIGN = {"rfnet": ["--trans_dim", "32", "--heads", "4", "--depth", "2"],
           "m2ftrans": ["--trans_dim", "32"]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("backbone_cli") / "data")
    make_synthetic_dataset(root, n_cases=6, shape=(24, 24, 20), seed=3)
    return root


def _train_args(name, data, out, epochs, *extra):
    return ["--model", name, "--device", "cpu", "--dataroot", data,
            "--datapath", ".", "--imbmrpath", "imb_split.csv",
            "--savepath", out, "--num_epochs", str(epochs), "--batch_size",
            "2", "--iters_per_epoch", "2", "--use_passion",
            "--num_workers", "2", "--patch_size", "16", *WIDTHS[name],
            *FOREIGN[name], *extra]


@pytest.mark.parametrize("name", ["rfnet", "m2ftrans"])
def test_train_resume_and_eval(name, data, tmp_path):
    out, resumed, scored = (str(tmp_path / d) for d in ("out", "resumed",
                                                        "eval"))
    port_train.main(_train_args(name, data, out, 1))
    with open(os.path.join(out, f"{name}.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 15 * 3
    assert not os.path.exists(os.path.join(out, "mmformer.csv"))
    last = os.path.join(out, "model_last.pt")
    assert ckpt.load_checkpoint(last)["epoch"] == 0

    port_train.main(_train_args(name, data, resumed, 2, "--resume", last))
    with open(os.path.join(resumed, "idt_training.txt")) as f:
        log = f.read()
    assert f"resumed from {last} at epoch 1" in log
    assert "Epoch 2/2, Iter 2/2" in log and "Epoch 1/2" not in log
    state = ckpt.load_checkpoint(os.path.join(resumed, "model_last.pt"))
    assert state["epoch"] == 1
    assert {s["count"] for s in state["optimizer"]["state"].values()} == {4}

    dice, hd95 = port_eval.main(
        ["--model", name, "--resume", last, "--device", "cpu", "--dataroot",
         data, "--datapath", ".", "--savepath", scored, "--patch_size", "16",
         *WIDTHS[name], *FOREIGN[name]])
    with open(os.path.join(scored, f"{name}.csv")) as f:
        rows = f.read().strip().splitlines()
    assert len(rows) == 1 + 15 * 3 and rows[0].endswith("HD95ETPro HD95")
    assert len(dice) == len(hd95)


def test_each_backbone_gets_only_its_width_flags():
    argv = ["--basic_dims", "4", "--trans_dim", "32", "--mlp_dim", "64",
            "--heads", "4", "--depth", "2"]
    want = {"rfnet": {"basic_dims": 4},
            "mmformer": {"basic_dims": 4, "trans_dim": 32, "mlp_dim": 64,
                         "heads": 4, "depth": 2},
            "m2ftrans": {"basic_dims": 4, "mlp_dim": 64, "heads": 4,
                         "depth": 2}}
    for name, kw in want.items():
        assert parse_train_config(["--model", name] + argv).model_kwargs == kw
        assert parse_config(["--model", name] + argv).model_kwargs == kw
    assert parse_train_config(["--model", "rfnet"]).model_kwargs == {}
