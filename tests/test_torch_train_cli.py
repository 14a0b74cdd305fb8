"""`python -m passion_tpu_torch.train --device cpu` at a tiny size
(patch 16, basic_dims 4, trans_dim 32, mlp_dim 64, heads 4) on synthetic
cases: two epochs, the reference's checkpoint retention, `--resume`, the
reference's TensorBoard tag set, the final 15-mask CSV, validation
(`--use_valid`) and two gloo ranks (`--data_parallel 2`)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from passion_tpu_torch import train as port_train
from passion_tpu_torch.data.synth import make_synthetic_dataset
from passion_tpu_torch.engine import checkpoint as ckpt
from passion_tpu_torch.engine.tb_writer import read_scalars
from passion_tpu_torch.masks import MASK_NAMES
from passion_tpu_torch.models import get_model, init_model

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's scalar tags (tests/test_tb_writer.py:17-20)
REF_TAGS = (["lr", "epoch_losses", "epoch_fuse_losses", "epoch_prm_losses",
             "epoch_sep_losses", "epoch_kl_losses", "epoch_proto_losses"]
            + [f"{k}_m{m}" for m in range(4)
               for k in ("kl", "sep", "proto", "dist", "rp")])
TINY = ["--patch_size", "16", "--basic_dims", "4", "--trans_dim", "32",
        "--mlp_dim", "64", "--heads", "4"]


def _args(data, out, epochs, *extra):
    return ["--device", "cpu", "--dataroot", data, "--datapath", ".",
            "--imbmrpath", "imb_split.csv", "--savepath", out,
            "--num_epochs", str(epochs), "--batch_size", "2",
            "--iters_per_epoch", "2", "--use_passion",
            "--region_fusion_start_epoch", "1", "--num_workers", "2",
            *TINY, *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One two-epoch run through `python -m passion_tpu_torch.train`."""
    root = tmp_path_factory.mktemp("train_cli")
    data, out = str(root / "data"), str(root / "out")
    make_synthetic_dataset(data, n_cases=6, shape=(24, 24, 20), seed=2)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the suite runs several workers at once
    proc = subprocess.run(
        [sys.executable, "-m", "passion_tpu_torch.train",
         *_args(data, out, 2)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return data, out


def test_two_epochs_write_checkpoints_log_and_csv(run):
    _, out = run
    files = set(os.listdir(out))
    # model_last every epoch, model_N for the last 5 epochs (here both)
    assert {"model_last.pt", "model_1.pt", "model_2.pt"} <= files
    last = ckpt.load_checkpoint(os.path.join(out, "model_last.pt"))
    assert last["epoch"] == 1
    counts = {s["count"] for s in last["optimizer"]["state"].values()}
    assert counts == {4}  # 2 epochs x 2 iterations
    with open(os.path.join(out, "idt_training.txt")) as f:
        log = f.read()
    assert "#############PASSION-IDT-Training############" in log
    assert "Epoch 2/2, Iter 2/2, Loss" in log and "imb_beta:[" in log
    with open(os.path.join(out, "mmformer.csv")) as f:
        assert len(f.read().strip().splitlines()) == 1 + 15 * 3


def test_tensorboard_has_the_reference_tag_set(run):
    _, out = run
    (events,) = os.listdir(os.path.join(out, "summary"))
    rows = read_scalars(os.path.join(out, "summary", events))
    assert {t for _, t, _ in rows} == set(REF_TAGS)
    assert sorted({s for s, _, _ in rows}) == [1, 2]
    assert all(np.isfinite(v) for _, _, v in rows)


def test_resume_continues_at_the_next_epoch(run, tmp_path):
    data, out = run
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    src = os.path.join(out, "model_last.pt")
    port_train.main(_args(data, resumed, 3, "--resume", src))
    with open(os.path.join(resumed, "idt_training.txt")) as f:
        log = f.read()
    assert f"resumed from {src} at epoch 2" in log
    assert "Epoch 3/3, Iter 2/2" in log and "Epoch 1/3" not in log
    assert set(os.listdir(resumed)) >= {"model_last.pt", "model_3.pt"}
    last = ckpt.load_checkpoint(os.path.join(resumed, "model_last.pt"))
    assert last["epoch"] == 2
    assert {s["count"] for s in last["optimizer"]["state"].values()} == {6}


def test_checkpoint_retention_follows_the_reference():
    names = {e: [os.path.basename(p) for p in
                 ckpt.checkpoint_paths("o", e, 300)] for e in
             (0, 98, 99, 199, 294, 295, 299)}
    assert names[0] == names[98] == names[294] == ["model_last.pt"]
    assert names[99] == ["model_last.pt", "model_100.pt"]
    assert names[199] == ["model_last.pt", "model_200.pt"]
    assert names[295] == ["model_last.pt", "model_296.pt"]
    assert names[299] == ["model_last.pt", "model_300.pt"]


def test_pretrained_merge_takes_matching_keys(tmp_path):
    kw = dict(patch_size=16, basic_dims=4, trans_dim=32, mlp_dim=64,
              heads=4)
    src = init_model(get_model("mmformer", **kw), seed=1)
    ckpt.save_checkpoint(str(tmp_path / "c.pt"),
                         {"epoch": 0, "model": src.state_dict(),
                          "optimizer": {}})
    # another num_cls: the seg heads differ in shape and keep their values
    dst = init_model(get_model("mmformer", num_cls=3, **kw), seed=2)
    head = dst.decoder_sep.seg_layer.weight.clone()
    taken = ckpt.load_pretrained_params(str(tmp_path / "c.pt"), dst)
    assert "encoders.e1_c1.weight" in taken
    assert "decoder_sep.seg_layer.weight" not in taken
    torch.testing.assert_close(dst.encoders.e1_c1.weight,
                               src.encoders.e1_c1.weight)
    torch.testing.assert_close(dst.decoder_sep.seg_layer.weight, head)


@pytest.mark.parametrize("flag", ["--use_valid", "--data_parallel"])
def test_unported_paths_refuse(run, tmp_path, flag):
    """The two paths the earlier slices refused now run: `--use_valid`,
    and `--data_parallel 2 --device cpu` (two gloo ranks, with validation).
    The TensorBoard tags gain the 15 mask names and `score_average`;
    `model_best.pt` exists exactly when epoch 2 beat epoch 1's score (the
    first validated epoch only sets the best score); only rank 0 writes:
    one event file, one log line per iteration, one CSV."""
    data, _ = run
    out = tmp_path / "o"
    extra = ["--use_valid"]
    if flag == "--data_parallel":
        extra += ["--data_parallel", "2"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "passion_tpu_torch.train",
         *_args(data, str(out), 2, *extra)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (events,) = os.listdir(out / "summary")
    rows = read_scalars(str(out / "summary" / events))
    assert {t for _, t, _ in rows} == set(REF_TAGS) | set(MASK_NAMES) | {
        "score_average"}
    assert all(np.isfinite(v) for _, _, v in rows)
    avg = dict((s, v) for s, t, v in rows if t == "score_average")
    assert sorted(avg) == [1, 2]
    files = set(os.listdir(out))
    assert files - {"model_best.pt"} == {
        "model_last.pt", "model_1.pt", "model_2.pt", "summary",
        "idt_training.txt", "mmformer.csv"}
    assert ("model_best.pt" in files) == (avg[2] > avg[1])
    if avg[2] > avg[1]:
        assert ckpt.load_checkpoint(str(out / "model_best.pt"))["epoch"] == 1
    with open(out / "idt_training.txt") as f:
        log = f.read()
    assert log.count("Epoch 2/2, Iter 2/2, Loss") == 1
    assert log.count("best epoch: ") == 2
    with open(out / "mmformer.csv") as f:
        assert len(f.read().strip().splitlines()) == 1 + 15 * 3
