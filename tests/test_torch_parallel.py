"""Data parallelism of the port (parallel/world.py) on the CPU: two gloo
ranks against one process, float32, dropout off, at the fast-tier widths
(RFNet basic_dims 4; mmFormer basic_dims 4, trans_dim 32, mlp_dim 64,
heads 4; patch 16).

  * one train step (RFNet, mmFormer): the metrics of both ranks equal the
    one-process step's at rtol 1e-5, the summed gradients are within 1e-5
    in relative L2 and the updated params within 2 lr (AdamW's sign on
    gradients that are almost zero, tests/test_mesh.py:112-139);
  * the preference gate is the global batch's: a batch whose rank-0 rows
    alone would gate a modality the other way, and a batch whose unimodal
    (NaN) row sits on rank 1, which closes the gate on both ranks;
  * a batch of 3 on 2 ranks: the padded row counts in no term;
  * the warmup branch, whose unused fuse path has no gradient: it takes
    part in the sum as zeros;
  * the sharded sweep: labels equal the one-process sweep's, normalised
    probabilities within 1e-5;
  * `launch` fails a rank that does not finish in time;
  * the JAX package's mesh step (2 host devices, params converted with
    `interop.jax_weights`, mmFormer at patch 32) on the same global
    batches, the padded batch of 3 and the NaN batch among them: the
    ranks' metrics at rtol 1e-4 and their summed gradients within 2e-3 in
    relative L2 over all tensors and 1e-2 per tensor (the reasons are in
    the test).

The ranks are spawned processes running tests/torch_ranks.py (torch and
the port only), each with one torch thread, a FileStore under the test's
tmp_path and a hard time limit.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import torch_ranks
from passion_tpu.engine import train_loop as jloop
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu.parallel.mesh import make_mesh, replicate, shard_batch_fn
from passion_tpu_torch.interop.jax_weights import mmformer_from_jax_params
from passion_tpu_torch.engine import train_loop
from passion_tpu_torch.engine.sliding_window import (SlidingWindowSweep,
                                                     coverage_weight)
from passion_tpu_torch.masks import MASK_ARRAY
from passion_tpu_torch.parallel import world as pw

torch.set_num_threads(2)
PATCH = 16
JAX_PATCH = 32  # at 16 the one-voxel bottleneck hides the transformers
MMFORMER_KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)
SPECS = {
    "rfnet": dict(name="rfnet", patch=PATCH, kw=dict(basic_dims=4), seed=0),
    "mmformer": dict(name="mmformer", patch=PATCH, kw=MMFORMER_KW, seed=0),
    # weights from the JAX params; the file is written by the fixture
    "mmformer_jax": dict(name="mmformer", patch=JAX_PATCH, kw=MMFORMER_KW,
                         state=None),
}
FULL, PART, PART2, UNI = ([1, 1, 1, 1], [1, 0, 1, 0], [0, 1, 1, 1],
                          [0, 0, 0, 1])
# tag: (backbone, masks of the global batch, data seed, rows padded to)
JOBS = {
    "rfnet": ("rfnet", [FULL, PART, PART2, [1, 1, 0, 1]], 5, 4),
    "mmformer": ("mmformer", [FULL, PART, PART2, [1, 1, 0, 1]], 5, 4),
    "three": ("mmformer", [FULL, PART, PART2], 5, 3),
    "warmup": ("mmformer", [FULL, PART, PART2, [1, 1, 0, 1]], 5, 4),
    "nan": ("mmformer", [FULL, PART, UNI, PART2], 6, 4),
    "jax_four": ("mmformer_jax", [FULL, PART, PART2, [1, 1, 0, 1]], 5, 4),
    "jax_three": ("mmformer_jax", [FULL, PART, PART2], 5, 3),
    "jax_nan": ("mmformer_jax", [FULL, PART, UNI, PART2], 6, 4),
}
PORT_TAGS = ["rfnet", "mmformer", "three", "warmup", "nan"]
WARMUP_TAGS = ("warmup",)  # the step's warmup branch: the fuse path unused
JAX_TAGS = ["jax_four", "jax_three", "jax_nan"]
JAX_SPECS = ("mmformer_jax",)
LAUNCH_TIMEOUT_S = 120


def _batch(masks, seed, patch=PATCH):
    """A channels-first global batch, as the training sets give it."""
    rng = np.random.default_rng(seed)
    b = len(masks)
    labels = rng.integers(0, 4, (b, patch, patch, patch))
    return dict(
        x=rng.standard_normal((b, 4, patch, patch, patch)).astype(np.float32),
        target=np.moveaxis(np.eye(4, dtype=np.float32)[labels], -1,
                           1).copy(),
        mask=np.asarray(masks, bool))


def _launch(fn, out, *args, timeout_s=LAUNCH_TIMEOUT_S):
    pw.launch(fn, 2, "cpu", args=(str(out),) + args,
              init_method=f"file://{out}/store", timeout_s=timeout_s,
              threads=1)


def _one_process(tag):
    name, masks, seed, bp = JOBS[tag]
    host = _batch(masks, seed)
    batch = train_loop._to_device(host, bp, torch.device("cpu"))
    return torch_ranks.run_step(torch_ranks.build_model(SPECS[name]), batch,
                                warmup=tag in WARMUP_TAGS)


@pytest.fixture(scope="module")
def jax_params():
    """Host params of the JAX mmFormer at JAX_PATCH (seed 0)."""
    jm = jax_get_model("mmformer", mask_type="idt", patch_size=JAX_PATCH,
                       **MMFORMER_KW)
    return jm, jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=JAX_PATCH,
                                     batch_size=2, scale=0.3))


@pytest.fixture(scope="module")
def steps(tmp_path_factory, jax_params):
    """Every step job on 2 gloo ranks (one launch), and the port's jobs in
    one process."""
    out = tmp_path_factory.mktemp("dp_steps")
    state = out / "mmformer_jax_state.pt"
    torch.save(mmformer_from_jax_params(jax_params[1]), state)
    jobs = {}
    for tag, (name, masks, seed, bp) in JOBS.items():
        spec = dict(SPECS[name], state=str(state)) if name in JAX_SPECS \
            else SPECS[name]
        torch.save({k: torch.from_numpy(v)
                    for k, v in _batch(masks, seed, spec["patch"]).items()},
                   out / f"{tag}_batch.pt")
        jobs[tag] = (spec, bp, tag in WARMUP_TAGS)
    _launch(torch_ranks.step_rank, out, jobs)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    return {tag: dict(single=_one_process(tag) if tag in PORT_TAGS else None,
                      ranks=[r[tag] for r in ranks])
            for tag in JOBS}


def _assert_metrics(got, ref):
    for k in train_loop.SCALARS + train_loop.VECTORS + ("rp_iter",):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("tag", PORT_TAGS)
def test_first_step_metrics_match_one_process(steps, tag):
    """Both ranks return the global batch's metrics."""
    res = steps[tag]
    for rank in res["ranks"]:
        _assert_metrics(rank["metrics"], res["single"]["metrics"])
    assert [r["rows"] for r in res["ranks"]] == [2, 2]


@pytest.mark.parametrize("tag", PORT_TAGS)
def test_summed_gradients_match_one_process(steps, tag):
    """The gradients after the all-reduce are the one-process gradients of
    the summed loss (not their mean): within 1e-5 in relative L2 over all
    tensors, and each tensor within 1e-5 of its norm plus a floor of 1e-6
    of the largest tensor norm (the biases that feed a norm, whose true
    gradient is zero)."""
    res = steps[tag]
    ref = res["single"]["grads"]
    floor = 1e-6 * max(v.norm().item() for v in ref.values())
    for rank in res["ranks"]:
        num = den = 0.0
        for name, want in ref.items():
            gap = (rank["grads"][name] - want).norm().item()
            assert gap <= 1e-5 * want.norm().item() + floor, name
            num += gap ** 2
            den += want.norm().item() ** 2
        assert (num / den) ** 0.5 <= 1e-5


@pytest.mark.parametrize("tag", PORT_TAGS)
def test_params_after_the_update_within_two_lr(steps, tag):
    res = steps[tag]
    for rank in res["ranks"]:
        for name, want in res["single"]["params"].items():
            torch.testing.assert_close(rank["params"][name], want, rtol=0,
                                       atol=2 * torch_ranks.LR, msg=name)
    a, b = (r["params"] for r in res["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)  # the same update


def test_warmup_missing_gradients_take_part_as_zeros(steps):
    """In the warmup branch the fuse path gets no gradient in one process;
    on the ranks those params hold zeros after the sum."""
    res = steps["warmup"]
    missing = res["single"]["no_grad"]
    assert any(n.startswith("fuse_path.") for n in missing)
    for rank in res["ranks"]:
        assert rank["no_grad"] == []
        assert all(not rank["grads"][n].any() for n in missing)


def test_gate_is_the_global_batchs(steps):
    """In the mmFormer batch rank 0's rows alone would gate at least one
    modality the other way than the whole batch does; both ranks follow
    the whole batch."""
    name, masks, seed, _ = JOBS["mmformer"]
    host = {k: v[:2] for k, v in _batch(masks, seed).items()}
    local = torch_ranks.run_step(
        torch_ranks.build_model(SPECS[name]),
        train_loop._to_device(host, 2, torch.device("cpu")))
    glob = steps["mmformer"]["single"]["metrics"]["rp_iter"]
    assert ((local["metrics"]["rp_iter"] > 0) != (glob > 0)).any()
    for rank in steps["mmformer"]["ranks"]:
        assert torch.equal(rank["metrics"]["rp_iter"] > 0, glob > 0)


def test_nan_row_on_rank_1_closes_the_gate_on_both_ranks(steps):
    """The unimodal sample (an all-zero dist row, so a NaN rp row) is row
    2, on rank 1; rank 0's own rows are finite. Both ranks see a NaN
    rp_iter and an all-False gate: no rp-gated loss this step."""
    host = {k: v[:2] for k, v in _batch(*JOBS["nan"][1:3]).items()}
    local = torch_ranks.run_step(
        torch_ranks.build_model(SPECS["mmformer"]),
        train_loop._to_device(host, 2, torch.device("cpu")))
    assert torch.isfinite(local["metrics"]["rp_iter"]).all()
    for rank in steps["nan"]["ranks"]:
        m = rank["metrics"]
        assert torch.isnan(m["rp_iter"]).all()
        assert m["sep_loss"].item() == 0 and m["proto_loss"].item() == 0
        torch.testing.assert_close(
            m["loss"], m["fuse_loss"] + m["prm_loss"] + 0.5 * m["kl_loss"],
            rtol=1e-6, atol=0)


def test_padded_row_of_a_batch_of_three_counts_in_nothing(steps):
    """3 rows on 2 ranks: rank 1 holds row 2 and a copy of row 0 with
    valid = 0; the step equals the one-process step of the 3 rows."""
    res = steps["three"]
    single3 = res["single"]["metrics"]
    host = _batch(JOBS["three"][1], JOBS["three"][2])
    padded = train_loop._to_device(host, 3, torch.device("cpu"),
                                   pw.World(1, 2, torch.device("cpu")))
    assert padded["valid"].tolist() == [1.0, 0.0]
    assert torch.equal(padded["x"][1], torch.from_numpy(host["x"][0]))
    for rank in res["ranks"]:
        _assert_metrics(rank["metrics"], single3)


def _grab_grads():
    """An optax transformation whose state is the last gradient and whose
    update is zero: the JAX step then hands back its exact gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def jax_mesh_steps(jax_params):
    """The JAX package's float32 step, dropout off, over a mesh of 2 host
    devices: params replicated, the global batch padded as its `fit` pads
    it (train_loop.py:427-436) and sharded over the batch axis."""
    jm, params = jax_params
    mesh = make_mesh(2)
    shard = shard_batch_fn(mesh)
    tx = _grab_grads()
    step = jloop.make_train_step(jm, tx, True, with_dropout=False,
                                 compute_dtype=None)
    out = {}
    for tag in JAX_TAGS:
        _, masks, seed, bp = JOBS[tag]
        host = _batch(masks, seed, JAX_PATCH)
        b = len(masks)
        bp = -(-bp // mesh.size) * mesh.size
        idx = np.concatenate([np.arange(b), np.zeros((bp - b,), np.int64)])
        arrays = {"x": np.moveaxis(host["x"], 1, -1)[idx],
                  "target": np.moveaxis(host["target"], 1, -1)[idx],
                  "mask": host["mask"][idx],
                  "valid": (np.arange(bp) < b).astype(np.float32)}
        _, grads, metrics = step(
            replicate(params, mesh), replicate(tx.init(params), mesh),
            shard(arrays), jnp.asarray(torch_ranks.BETA, jnp.float32),
            jnp.asarray(torch_ranks.MODAL_W, jnp.float32), jnp.float32(4.0),
            jax.random.PRNGKey(0), False)
        out[tag] = dict(
            metrics={k: np.asarray(v) for k, v in metrics.items()},
            grads={k: v.numpy().astype(np.float64) for k, v in
                   mmformer_from_jax_params(jax.tree_util.tree_map(
                       np.asarray, grads)).items()})
    return out


@pytest.mark.parametrize("tag", JAX_TAGS)
def test_two_ranks_match_the_jax_mesh_step(steps, jax_mesh_steps, tag):
    """Both ranks against the JAX mesh step on the same global batch.

    Metrics at rtol 1e-4 (the first step of tests/test_torch_train_step.py),
    rp_iter with the same NaNs and the same gate. Gradients: the ranks' sum
    within 2e-3 of JAX's in relative L2 over all tensors, and each tensor
    within 1e-2 of its norm plus a floor of 1e-6 of the largest tensor norm
    (the biases that feed a norm, whose true gradient is zero). That is
    the gap of the port's one-process float32 step to JAX's at these widths,
    up to 0.5% on the tensors where the problem defines the gradient less
    well (tests/test_torch_train_step.py); the JAX mesh step equals JAX's
    one-device step to 3e-7. What the test is for is far larger: a mean in
    place of the sum halves every gradient (relative L2 0.5), and a padded
    row that counted, or a gate taken on one rank's rows, moves the
    metrics by a share of the batch."""
    ref = jax_mesh_steps[tag]
    floor = 1e-6 * max(np.linalg.norm(v) for v in ref["grads"].values())
    for rank in steps[tag]["ranks"]:
        got = rank["metrics"]
        for k in train_loop.SCALARS + train_loop.VECTORS:
            np.testing.assert_allclose(got[k].numpy(), ref["metrics"][k],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        g_rp, r_rp = got["rp_iter"].numpy(), ref["metrics"]["rp_iter"]
        np.testing.assert_array_equal(np.isnan(g_rp), np.isnan(r_rp))
        np.testing.assert_array_equal(g_rp > 0, r_rp > 0)
        ok = ~np.isnan(r_rp)
        np.testing.assert_allclose(g_rp[ok], r_rp[ok], rtol=1e-3, atol=1e-4)
        num = den = 0.0
        for name, want in ref["grads"].items():
            gap = np.linalg.norm(rank["grads"][name].numpy() - want)
            assert gap <= 1e-2 * np.linalg.norm(want) + floor, name
            num += gap ** 2
            den += np.linalg.norm(want) ** 2
        assert (num / den) ** 0.5 <= 2e-3
    if tag == "jax_nan":
        assert np.isnan(ref["metrics"]["rp_iter"]).all()


def test_sharded_sweep_matches_one_process(tmp_path):
    """The mmFormer sweep with its 8 windows in chunks of 3 (3 chunks: 2 on
    rank 0, 1 on rank 1) against the one-process sweep."""
    spec = SPECS["mmformer"]
    masks = [np.asarray(m) for m in MASK_ARRAY[::3]]
    vol = np.random.default_rng(4).standard_normal((24, 24, 20, 4)).astype(
        np.float32)
    np.save(tmp_path / "vol.npy", vol)
    _launch(torch_ranks.sweep_rank, tmp_path, spec, masks, [3])
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)[3]
             for r in range(2)]
    assert [len(r["chunks"]) for r in ranks] == [2, 1]

    engine = SlidingWindowSweep(torch_ranks.build_model(spec), 4, PATCH,
                                window_batch=3, compute_dtype=torch.float32,
                                device="cpu")
    prepared = engine.prepare(vol)
    labels = engine.sweep_labels(prepared, masks)
    fts = engine.encode_case(prepared)
    wgt = torch.from_numpy(coverage_weight(prepared["eff"], prepared["eff"],
                                           PATCH))
    for r in ranks:
        for m, lab, got_lab, got_p in zip(masks, labels, r["labels"],
                                          r["probs"]):
            np.testing.assert_array_equal(got_lab, lab)
            torch.testing.assert_close(
                got_p, engine.sum_masked(prepared, fts, m) / wgt, rtol=0,
                atol=1e-5)
    assert len(np.unique(np.concatenate([v.ravel() for v in labels]))) > 1


def test_auto_window_batch_splits_chunks_over_ranks():
    engine = SlidingWindowSweep(torch_ranks.build_model(SPECS["rfnet"]), 4,
                                80, device="cpu",
                                world=pw.World(1, 2, torch.device("cpu")))
    prepared = engine.prepare(np.zeros((240, 240, 155, 4), np.float32))
    assert prepared["window_batch"] == 38  # 75 windows in 2 chunks
    assert [len(c) for c in engine._rank_chunks(prepared)] == [37]


def test_a_stalled_rank_fails_the_launch(tmp_path):
    with pytest.raises(TimeoutError):
        _launch(torch_ranks.stall_rank, tmp_path, 120.0, timeout_s=8)


def test_world_size_for_keeps_the_jax_meaning():
    assert pw.world_size_for(0, "cpu") == pw.world_size_for(0, "cuda") == 0
    assert pw.world_size_for(3, "cpu") == 3
    with pytest.raises(ValueError):
        pw.world_size_for(-1, "cpu")
    if not torch.cuda.is_available():
        for n in (-1, 1, 2):
            with pytest.raises(RuntimeError, match="visible"):
                pw.world_size_for(n, "cuda")
    else:
        visible = torch.cuda.device_count()
        assert pw.world_size_for(-1, "cuda") == visible
        with pytest.raises(RuntimeError):
            pw.world_size_for(visible + 1, "cuda")


def test_rank_programs_import_no_jax():
    """tests/torch_ranks.py is what a spawned rank imports: torch, numpy
    and the port only."""
    with open(os.path.join(os.path.dirname(__file__), "torch_ranks.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert names and all(n.split(".")[0] in ("os", "time", "numpy", "torch",
                                             "passion_tpu_torch")
                         for n in names), names


def test_eval_cli_with_two_ranks_writes_the_one_process_csv(tmp_path):
    """`python -m passion_tpu_torch.eval --data_parallel 2 --device cpu`
    (chunks of 3 windows split over the ranks, rank 0 writes) against the
    same command on one device."""
    import csv
    import subprocess
    import sys

    from passion_tpu_torch.data.synth import make_synthetic_dataset

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = str(tmp_path / "data")
    make_synthetic_dataset(data, n_cases=6, shape=(24, 24, 20), seed=2)
    model = torch_ranks.build_model(SPECS["mmformer"])
    torch.save(model.state_dict(), tmp_path / "m.pt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    rows = {}
    for ranks in ("0", "2"):
        out = tmp_path / f"out{ranks}"
        proc = subprocess.run(
            [sys.executable, "-m", "passion_tpu_torch.eval", "--device",
             "cpu", "--resume", str(tmp_path / "m.pt"), "--dataroot", data,
             "--datapath", ".", "--savepath", str(out), "--patch_size",
             str(PATCH), "--basic_dims", "4", "--trans_dim", "32",
             "--mlp_dim", "64", "--heads", "4", "--window_batch", "3",
             "--data_parallel", ranks], cwd=repo, env=env,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert sorted(os.listdir(out)) == ["idt_eval.txt", "mmformer.csv"]
        with open(out / "mmformer.csv") as f:
            rows[ranks] = list(csv.reader(f))
    assert len(rows["2"]) == len(rows["0"]) == 1 + 15 * 3
    for g, r in zip(rows["2"], rows["0"]):
        if len(r) < 8:
            assert g == r
            continue
        np.testing.assert_allclose(np.float64(g[:4]), np.float64(r[:4]),
                                   atol=1e-4)
        np.testing.assert_allclose(np.float64(g[4:]), np.float64(r[4:]),
                                   atol=0.5)
