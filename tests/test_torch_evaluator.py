"""passion_tpu_torch's evaluation against the JAX package's: metrics,
synthetic data, `run_test_sweep`'s CSV from both engines on two synthetic
cases (float32: the same rows, Dice within 1e-4), and the
`python -m passion_tpu_torch.eval` entry point on the CPU."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passion_tpu import metrics as jmetrics
from passion_tpu.data.datasets import BratsTest as JaxBratsTest
from passion_tpu.data.loader import PrefetchLoader
from passion_tpu.data.synth import make_case as jax_make_case
from passion_tpu.engine.evaluator import run_test_sweep as jax_run_test_sweep
from passion_tpu.engine.sliding_window import SlidingWindowSweep as JaxSweep
from passion_tpu.models import get_model as jax_get_model
from passion_tpu.models import init_params_host
from passion_tpu_torch import eval as port_eval
from passion_tpu_torch import metrics as tmetrics
from passion_tpu_torch.data.datasets import TEST_TRANSFORMS, BratsTest, \
    CaseLoader
from passion_tpu_torch.data.synth import make_case, make_synthetic_dataset
from passion_tpu_torch.engine import evaluator as tev
from passion_tpu_torch.engine.evaluator import run_test_sweep
from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
from passion_tpu_torch.interop.jax_weights import mmformer_from_jax_params
from passion_tpu_torch.models import get_model, init_model

torch.set_num_threads(2)
PATCH = 16
KW = dict(basic_dims=4, trans_dim=32, mlp_dim=64, heads=4)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_port_eval")
    make_synthetic_dataset(str(root), n_cases=6, shape=(24, 24, 20), seed=5)
    return str(root)


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_csv_matches_jax_engine(dataset, tmp_path):
    jm = jax_get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    params = jax.tree_util.tree_map(
        np.asarray, init_params_host(jm, seed=0, patch_size=PATCH,
                                     scale=0.3))
    tm = get_model("mmformer", mask_type="idt", patch_size=PATCH, **KW)
    tm.load_state_dict(mmformer_from_jax_params(params), strict=True)

    jax_csv, port_csv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jloader = PrefetchLoader(JaxBratsTest(TEST_TRANSFORMS, root=dataset),
                             batch_size=1, shuffle=False, num_threads=1)
    jdice, jhd, _ = jax_run_test_sweep(
        jloader, JaxSweep(jm, 4, PATCH, window_batch=4,
                          compute_dtype=jnp.float32), params,
        csv_name=jax_csv)
    dice, hd, per_mask = run_test_sweep(
        CaseLoader(BratsTest(TEST_TRANSFORMS, root=dataset)),
        SlidingWindowSweep(tm, 4, PATCH, window_batch=4,
                           compute_dtype=torch.float32, device="cpu"),
        csv_name=port_csv)

    ref, got = _read_csv(jax_csv), _read_csv(port_csv)
    assert len(got) == len(ref) == 1 + 15 * 3  # header + 15 x (name, 2 cases)
    assert got[0] == ref[0] and got[0][-1] == "ET HD95ETPro HD95"
    assert got[1] == ["flairt1cet1t2"]  # reversed mask order
    assert len(per_mask) == 15
    for g, r in zip(got[1:], ref[1:]):
        assert len(g) == len(r)
        if len(r) == 1:
            assert g == r
            continue
        # Dice within 1e-4; HD95 within half a voxel (a near-tie voxel may
        # move one surface point)
        np.testing.assert_allclose(np.float64(g[:4]), np.float64(r[:4]),
                                   atol=1e-4)
        np.testing.assert_allclose(np.float64(g[4:]), np.float64(r[4:]),
                                   atol=0.5)
    np.testing.assert_allclose(dice, jdice, atol=1e-4)
    np.testing.assert_allclose(hd, jhd, atol=0.5)


def test_eval_entry_point(dataset, tmp_path):
    """`python -m passion_tpu_torch.eval` on the CPU (bf16, its serving
    dtype) writes the same CSV as the engine it wires up."""
    model = init_model(get_model("mmformer", patch_size=PATCH,
                                 basic_dims=4), seed=1)
    ckpt = str(tmp_path / "m.pt")
    torch.save(model.state_dict(), ckpt)
    out = tmp_path / "out"
    port_eval.main(["--resume", ckpt, "--dataroot", dataset, "--datapath",
                    ".", "--savepath", str(out), "--patch_size",
                    str(PATCH), "--basic_dims", "4", "--device", "cpu"])
    ref_csv = str(tmp_path / "ref.csv")
    run_test_sweep(CaseLoader(BratsTest(TEST_TRANSFORMS, root=dataset)),
                   SlidingWindowSweep(model, 4, PATCH, device="cpu"),
                   csv_name=ref_csv)
    got = _read_csv(out / "mmformer.csv")
    assert got == _read_csv(ref_csv)
    scores = np.float64([r for r in got[1:] if len(r) == 8])
    assert scores.shape == (30, 8) and np.isfinite(scores).all()
    assert (out / "idt_eval.txt").is_file()


def test_eval_cli_reads_cases_in_a_prefetch_thread(dataset, tmp_path,
                                                   monkeypatch):
    """The eval CLI loads its test cases through a `PrefetchLoader` thread,
    one case a batch, in the list's order (JAX eval.py:52-53)."""
    made = []

    class Recording(port_eval.PrefetchLoader):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append((kw, []))

        def __iter__(self):
            for batch in super().__iter__():
                made[-1][1].append(list(batch["name"]))
                yield batch

    monkeypatch.setattr(port_eval, "PrefetchLoader", Recording)
    model = init_model(get_model("mmformer", patch_size=PATCH,
                                 basic_dims=4), seed=1)
    ckpt = str(tmp_path / "m.pt")
    torch.save(model.state_dict(), ckpt)
    port_eval.main(["--resume", ckpt, "--dataroot", dataset, "--datapath",
                    ".", "--savepath", str(tmp_path / "out"), "--patch_size",
                    str(PATCH), "--basic_dims", "4", "--device", "cpu"])
    (kw, names), = made
    assert kw == dict(batch_size=1, shuffle=False, num_threads=1)
    assert names == [[n] for n in
                     BratsTest(TEST_TRANSFORMS, root=dataset).names]
    assert len(names) == 2


def _cases(n, log, shape=(6, 5, 4)):
    """A loader of n one-case batches; case i's volume is all i."""
    for i in range(n):
        log.append(("load", i))
        yield dict(x=np.full((1,) + shape + (4,), i, np.float32),
                   target=np.zeros((1,) + shape, np.int64), name=[f"c{i}"])


class _RecordingSweep:
    """A sweep engine that logs when each case is dispatched and fetched;
    every label volume is empty."""

    def __init__(self, log):
        self.log = log

    def prepare(self, x):
        return int(x.flat[0]), x.shape[:3]

    def dispatch_labels(self, prepared, masks):
        self.log.append(("dispatch", prepared[0]))
        return prepared, len(masks)

    def fetch_labels(self, pending):
        (i, shape), n = pending
        self.log.append(("fetch", i))
        return [np.zeros(shape, np.uint8)] * n


def test_sweep_dispatches_the_next_case_before_fetching():
    """Case i + 1 is loaded and its device work queued before case i's
    labels are fetched (JAX evaluator.py:199-209)."""
    log = []
    run_test_sweep(_cases(4, log), _RecordingSweep(log))
    order = [e for e in log if e[0] != "load"]
    assert order == [("dispatch", 0), ("dispatch", 1), ("fetch", 0),
                     ("dispatch", 2), ("fetch", 1), ("dispatch", 3),
                     ("fetch", 2), ("fetch", 3)]
    assert log.index(("load", 1)) < log.index(("fetch", 0))


class _GatedPool:
    """A stand-in for the HD95 thread pool whose jobs wait until their
    result is read: jobs submitted and not yet read are the backlog the
    evaluator holds, with their label volumes."""

    def __init__(self, max_workers=None):
        self.submitted, self.read = 0, 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        self.submitted += 1
        pool = self

        class Job:
            def result(self):
                pool.read += 1
                return fn(*args)

        return Job()


def test_hd95_backlog_stays_within_two_cases(monkeypatch):
    """After each case at most 2 x 15 HD95 jobs wait (JAX evaluator.py:
    196-197), and every one is read by the end."""
    pools = []

    def make_pool(max_workers=None):
        pools.append(_GatedPool(max_workers))
        return pools[-1]

    monkeypatch.setattr(tev, "ThreadPoolExecutor", make_pool)
    backlog, log = [], []

    def loader():
        for batch in _cases(6, log):
            if pools:
                backlog.append(pools[0].submitted - pools[0].read)
            yield batch

    _, _, per_mask = run_test_sweep(loader(), _RecordingSweep(log))
    (pool,) = pools
    assert pool.submitted == pool.read == 6 * 15
    assert backlog == [0, 0, 15, 30, 30, 30]
    assert len(per_mask) == 15


def test_eval_requires_resume(tmp_path):
    with pytest.raises(SystemExit):
        port_eval.main(["--savepath", str(tmp_path), "--device", "cpu"])


def test_dice_and_hd95_match_jax(rng):
    out = np.stack([jax_make_case((24, 20, 16), rng)[1] for _ in range(2)])
    tgt = np.stack([jax_make_case((24, 20, 16), rng)[1] for _ in range(2)])
    out[1, 5:9] = 3  # ET above and below the post-processing threshold
    ref_sep, ref_ev = jmetrics.dice_class4(jnp.asarray(out), jnp.asarray(tgt))
    sep, ev = tmetrics.dice_class4(out, tgt)
    np.testing.assert_allclose(sep, np.asarray(ref_sep), rtol=1e-6)
    np.testing.assert_allclose(ev, np.asarray(ref_ev), rtol=1e-6)
    for k in range(2):
        assert tmetrics.cal_hd95(out[k], tgt[k]) == jmetrics.cal_hd95(
            out[k], tgt[k])
    assert tmetrics.cal_hd95(np.zeros((4, 4, 4)), np.zeros((4, 4, 4))) == (
        0.0, 0.0, 0.0, 0.0)


def test_synthetic_cases_match_jax():
    a = make_case((20, 18, 16), np.random.default_rng(3))
    b = jax_make_case((20, 18, 16), np.random.default_rng(3))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_brats_test_reads_cases(dataset):
    """The default cast, no pipeline, and a non-default pipeline (random
    flips; with the default generator and with a given one) give the JAX
    package's items."""
    ds = BratsTest(TEST_TRANSFORMS, root=dataset)
    jds = JaxBratsTest(TEST_TRANSFORMS, root=dataset)
    assert len(ds) == len(jds) == 2
    item, ref = ds.get(1), jds.get(1)
    assert item["name"] == ref["name"]
    for k in ("x", "target"):
        assert item[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(item[k], ref[k])
    flips = "Compose([RandomFlip(0), NumpyType((np.float32, np.int64)),])"
    for spec in ("", flips):
        ds, jds = BratsTest(spec, root=dataset), JaxBratsTest(spec,
                                                              root=dataset)
        for rng in (None, 4):
            for i in range(2):
                item = ds.get(i, None if rng is None else
                              np.random.default_rng(rng))
                ref = jds.get(i, None if rng is None else
                              np.random.default_rng(rng))
                for k in ("x", "target"):
                    assert item[k].dtype == ref[k].dtype
                    np.testing.assert_array_equal(item[k], ref[k])
    flipped = BratsTest(flips, root=dataset).get(0)["x"]
    assert not np.array_equal(flipped, BratsTest(
        TEST_TRANSFORMS, root=dataset).get(0)["x"])
