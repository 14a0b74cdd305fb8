"""K5's plain version and the 15-mask scorer on the labels' device, on the
CPU: `ops.edt.edt_sq_plain` (with its border) against scipy's distance
transform exactly; `metrics.score_masks` against the port's host metrics
(Dice bit for bit, HD95 within 1e-9) and the JAX package's (its float32
Dice within 1e-6); the histogram
percentile against `np.percentile`; and `run_test_sweep`'s device-scoring
branch, driven here with the plain versions on CPU tensors, against its
host branch (the same CSV bytes and averages). K5 itself runs on the card:
tests/test_torch_gpu.py holds it to the plain version there; here its
launch geometry (`ops.edt._plan`) is held to the card's limits for every
shape K5 is given, and the wrapper's limits are checked one voxel beyond
each."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from passion_tpu import metrics as jmetrics
from passion_tpu_torch import metrics as tmetrics
from passion_tpu_torch.data.datasets import TEST_TRANSFORMS, BratsTest, \
    CaseLoader
from passion_tpu_torch.data.synth import make_synthetic_dataset
from passion_tpu_torch.engine import evaluator as tev
from passion_tpu_torch.engine.sliding_window import SlidingWindowSweep
from passion_tpu_torch.models import get_model, init_model
from passion_tpu_torch.ops import edt

torch.set_num_threads(2)
FOOTPRINT = ndimage.generate_binary_structure(3, 1)
SHAPE = (33, 32, 34)  # room for an ET region of 500 voxels


def _border(region):
    return region ^ ndimage.binary_erosion(region, structure=FOOTPRINT,
                                           iterations=1)


def _volume(kind, shape, rng):
    """uint8 labels 0..3 of one kind of test volume."""
    if kind == "speckled":
        return rng.integers(0, 4, shape).astype(np.uint8)
    if kind == "faces":  # a region touching all six faces, holes inside
        lab = np.full(shape, 3, np.uint8)
        lab[rng.random(shape) < 0.2] = 0
        return lab
    if kind == "single":
        lab = np.zeros(shape, np.uint8)
        lab[tuple(s // 2 for s in shape)] = 3
        return lab
    if kind == "full":
        return np.full(shape, 2, np.uint8)
    if kind == "empty":
        return np.zeros(shape, np.uint8)
    raise ValueError(kind)


@pytest.mark.parametrize("shape", [(24, 20, 16), (7, 1, 5), (9, 8, 1)])
@pytest.mark.parametrize("kind", ["speckled", "faces", "single", "full",
                                  "empty"])
def test_plain_transform_equals_scipy(shape, kind):
    rng = np.random.default_rng([*shape, len(kind)])
    lab = np.stack([_volume(kind, shape, rng),
                    _volume("speckled", shape, rng)])
    for classes in tmetrics.REGIONS:
        got = edt.edt_sq_plain(torch.from_numpy(lab), classes).numpy()
        assert got.dtype == np.int32
        for k in range(2):
            border = _border(np.isin(lab[k], classes))
            np.testing.assert_array_equal(
                edt.border_plain(torch.from_numpy(lab[k:k + 1]),
                                 classes)[0].numpy(), border)
            if not border.any():
                assert (got[k] == edt.INF).all()
                continue
            want = ndimage.distance_transform_edt(~border,
                                                  sampling=(1.0, 1.0, 1.0))
            # scipy's distances are the square roots of these integers
            np.testing.assert_array_equal(
                np.sqrt(got[k].astype(np.float64)), want)
            np.testing.assert_array_equal(got[k] == 0, border)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    lab = torch.from_numpy(_volume("speckled", (6, 5, 4),
                                   np.random.default_rng(0)))[None]
    before = edt.edt_sq.launches
    assert torch.equal(edt.edt_sq(lab, (1, 3)), edt.edt_sq_plain(lab, (1, 3)))
    assert edt.edt_sq.launches == before
    with pytest.raises(TypeError):
        edt.edt_sq(lab.long(), (3,))
    with pytest.raises(ValueError):
        edt.edt_sq(lab, ())


# every shape K5 is given today: BraTS volumes one at a time and as the
# scorer's 15-mask batch, chip_smoke.py's phase 6b and the gpu tests
# (tests/test_torch_gpu.py), among them the planes that only just fit
USED_SHAPES = [(1, 240, 240, 155), (2, 240, 240, 155), (15, 240, 240, 155),
               (3, 24, 20, 16), (2, 7, 1, 5), (1, 9, 8, 1), (2, 40, 300, 33),
               (2, 5, 240, 234), (1, 4, 300, 126), (3, 7, 24, 40)]


@pytest.mark.parametrize("shape", USED_SHAPES)
def test_plan_fits_the_card(shape):
    """`_plan`'s launch geometry fits an sm_90 block: shared memory within
    232,448 bytes, whole warps, at most 1024 threads, whole groups of
    `LANES` threads a line; one block a plane in pass A and one a run of
    `b_lines` (w, z) offsets in pass B."""
    n, h, w, z = shape
    edt._check(torch.empty(shape, dtype=torch.uint8))
    plan = edt._plan(shape)
    assert edt.MAX_SHARED == 232_448
    for part in ("a", "b"):
        threads, shared = plan[f"{part}_threads"], plan[f"{part}_shared"]
        assert 0 < shared <= edt.MAX_SHARED, part
        assert 32 <= threads <= 1024 and threads % 32 == 0, part
        assert threads % edt.LANES == 0, part
    assert plan["a_threads"] <= edt.A_THREADS
    assert plan["a_blocks"] == n * h
    assert plan["b_threads"] == plan["b_lines"] * edt.LANES
    assert plan["b_blocks"] == n * -(-w * z // plan["b_lines"])
    # pass A's shared memory: the three label planes, or the 16-bit Z
    # distances and the W envelopes; the border bits; the mbarrier
    assert plan["a_shared"] >= max(3 * w * z, 4 * w * z) + 16


def _largest_z(w):
    z = 1
    while edt._plan((1, 2, w, z + 1))["a_shared"] <= edt.MAX_SHARED:
        z += 1
    return z


@pytest.mark.parametrize("name", ["H", "W", "Z", "plane", "plane, W > 256"])
def test_wrapper_raises_just_beyond_each_limit(name):
    """At each limit `_check` takes the shape; one voxel beyond it the
    wrapper raises ValueError, on any device, before any work."""
    at, beyond = {
        "H": ((1, edt.MAX_H, 1, 1), (1, edt.MAX_H + 1, 1, 1)),
        "W": ((1, 1, edt.MAX_W, 1), (1, 1, edt.MAX_W + 1, 1)),
        "Z": ((1, 1, 1, edt.MAX_Z), (1, 1, 1, edt.MAX_Z + 1)),
        "plane": ((1, 2, 240, _largest_z(240)),
                  (1, 2, 240, _largest_z(240) + 1)),
        "plane, W > 256": ((1, 2, 300, _largest_z(300)),
                           (1, 2, 300, _largest_z(300) + 1)),
    }[name]
    edt._check(torch.empty(at, dtype=torch.uint8))
    with pytest.raises(ValueError):
        edt.edt_sq(torch.zeros(beyond, dtype=torch.uint8), (1, 2, 3))


def test_limits_take_the_brats_plane_with_room():
    """A 240 x 240 x 155 case's plane takes under two thirds of a block's
    shared memory in pass A, and its 32 H lines under a quarter in pass
    B, so four blocks share an SM."""
    plan = edt._plan((15, 240, 240, 155))
    assert plan["a_shared"] == 153_616
    assert plan["a_shared"] <= 2 / 3 * edt.MAX_SHARED
    assert 4 * (plan["b_shared"] + 1024) <= 233_472
    assert _largest_z(240) > 155 and _largest_z(300) > 33


def _target(shape):
    """A clean target: nested spheres of ED (2), NCR (1) and ET (3)."""
    grid = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    r2 = sum((g - s // 2) ** 2 for g, s in zip(grid, shape))
    tgt = np.zeros(shape, np.uint8)
    tgt[r2 <= 100] = 2
    tgt[r2 <= 49] = 1
    tgt[r2 <= 16] = 3
    return tgt, r2


def _predictions(rng):
    """Label volumes of every kind the scorer distinguishes."""
    tgt, r2 = _target(SHAPE)
    preds = {"speckled": rng.integers(0, 4, SHAPE).astype(np.uint8),
             "clean": tgt.copy(),
             "empty": np.zeros(SHAPE, np.uint8)}
    shifted = np.roll(tgt, 2, axis=0)
    shifted[(r2 > 100) & (r2 <= 121)] = 3  # a shell of ET outside
    preds["shifted"] = shifted
    no_et = np.where(tgt == 3, 1, tgt).astype(np.uint8)
    preds["no_et"] = no_et
    for n in (499, 500):  # ET just under and just over the rule's 500
        lab = no_et.copy()
        lab[tuple(np.argwhere(lab == 0)[:n].T)] = 3
        preds[f"et_{n}"] = lab
    return preds


@pytest.mark.parametrize("target_kind", ["clean", "empty", "no_et",
                                         "speckled"])
def test_device_scorer_equals_the_host_metrics(target_kind):
    rng = np.random.default_rng(11)
    preds = _predictions(rng)
    tgt = {"clean": _target(SHAPE)[0], "empty": np.zeros(SHAPE, np.uint8),
           "no_et": preds["no_et"],
           "speckled": rng.integers(0, 4, SHAPE).astype(np.uint8)}[
        target_kind]
    names = list(preds)
    labels = np.stack([preds[n] for n in names])
    dice, hd = tmetrics.score_masks(torch.from_numpy(labels),
                                    torch.from_numpy(tgt))
    assert dice.dtype == np.float32 and dice.shape == (len(names), 4)
    assert hd.dtype == np.float64 and hd.shape == (len(names), 4)
    _, want_dice = tmetrics.dice_class4(labels, np.stack([tgt] * len(names)))
    _, jax_dice = jmetrics.dice_class4(jnp.asarray(labels),
                                       jnp.asarray(np.stack([tgt] *
                                                            len(names))))
    np.testing.assert_array_equal(dice, want_dice)
    # the JAX package divides in float32, where EPS vanishes: one float32
    # ulp apart on near-zero scores (as in test_torch_evaluator.py)
    np.testing.assert_allclose(dice, np.asarray(jax_dice), rtol=1e-6)
    for m, name in enumerate(names):
        want = tmetrics.cal_hd95(labels[m], tgt)
        np.testing.assert_allclose(hd[m], want, rtol=0, atol=1e-9,
                                   err_msg=name)
        np.testing.assert_allclose(hd[m], jmetrics.cal_hd95(labels[m], tgt),
                                   rtol=0, atol=1e-9, err_msg=name)


def test_device_scorer_refuses_labels_above_3():
    lab = np.zeros((1, 4, 4, 4), np.uint8)
    lab[0, 1, 1, 1] = 4
    with pytest.raises(ValueError):
        tmetrics.score_masks(torch.from_numpy(lab),
                             torch.zeros((4, 4, 4), dtype=torch.uint8))


@pytest.mark.parametrize("values", [
    [0], [5], [0, 0, 0, 1], [4, 4, 4, 4, 9, 9, 9], list(range(20)),
    [2] * 19 + [8], [2] * 20 + [8], [1] * 7 + [3] * 5 + [27] * 3 + [50],
])
def test_histogram_percentile_equals_numpy(values):
    rng = np.random.default_rng(len(values))
    rows = [np.asarray(values), rng.integers(0, 60, 1 + len(values) * 37)]
    hist = torch.stack([torch.bincount(torch.from_numpy(r), minlength=64)
                        for r in rows])
    got = tmetrics.percentile95_of_histograms(hist)
    want = [np.percentile(np.sqrt(r.astype(np.float64)), 95) for r in rows]
    np.testing.assert_array_equal(got, want)


def test_histogram_percentile_equals_numpy_on_random_multisets():
    """400 multisets of squared distances, among them sizes where numpy's
    two interpolation forms round apart in the last bit."""
    rng = np.random.default_rng(3)
    rows = [rng.integers(0, 300, int(rng.integers(2, 400)))
            for _ in range(400)]
    hist = torch.stack([torch.bincount(torch.from_numpy(r), minlength=300)
                        for r in rows])
    want = [np.percentile(np.sqrt(r.astype(np.float64)), 95) for r in rows]
    np.testing.assert_array_equal(tmetrics.percentile95_of_histograms(hist),
                                  want)


def _read(path):
    with open(path) as f:
        return f.read()


def _both_branches(monkeypatch, tmp_path, loader, engine):
    """The host branch's and the device branch's CSV text and averages."""
    out, calls = {}, []

    def spy(labels, target):
        calls.append(labels.shape)
        return tmetrics.score_masks(labels, target)

    monkeypatch.setattr(tev, "score_masks", spy)
    for branch in ("host", "device"):
        if branch == "device":
            monkeypatch.setattr(tev, "_scores_on_device", lambda e: True)
        csv_name = str(tmp_path / f"{branch}.csv")
        spans = tev.SweepSpans(keep_labels=True)
        dice, hd, per_mask = tev.run_test_sweep(loader(), engine,
                                                csv_name=csv_name,
                                                spans=spans)
        out[branch] = (_read(csv_name), dice, hd, per_mask, spans)
        # the device branch scores each case's 15 volumes in one call
        assert len(calls) == (0 if branch == "host" else len(spans.labels))
    assert all(shape[0] == 15 for shape in calls)
    return out


def _assert_same(out):
    (text, dice, hd, per_mask, spans), (dtext, ddice, dhd, dper_mask,
                                         dspans) = out["host"], out["device"]
    assert dtext == text
    assert len(list(csv.reader(text.splitlines()))) == 1 + 15 * 3
    np.testing.assert_array_equal(ddice, dice)
    np.testing.assert_array_equal(dhd, hd)
    for name, v in per_mask.items():
        np.testing.assert_array_equal(dper_mask[name]["dice"], v["dice"])
        np.testing.assert_array_equal(dper_mask[name]["hd95"], v["hd95"])
    assert dspans.score_s > 0 and len(dspans.labels) == len(spans.labels)


class _FixedSweep:
    """A sweep engine on the CPU whose labels are given: case i's mask j
    gets volumes[(i + j) % len(volumes)]."""

    device = torch.device("cpu")

    def __init__(self, volumes):
        self.volumes = volumes

    def prepare(self, x):
        return int(x.flat[0])

    def dispatch_labels(self, i, masks):
        labs = [torch.from_numpy(self.volumes[(i + j) % len(self.volumes)])
                for j in range(len(masks))]
        return labs, None, labs

    def fetch_labels(self, pending):
        return [lab.numpy() for lab in pending[0]]

    def device_labels(self, pending):
        return pending[2]


def test_device_branch_writes_the_host_branch_csv(monkeypatch, tmp_path):
    """Every kind of prediction against a clean target and an empty one."""
    rng = np.random.default_rng(5)
    volumes = list(_predictions(rng).values())
    targets = [_target(SHAPE)[0], np.zeros(SHAPE, np.uint8)]

    def loader():
        for i, tgt in enumerate(targets):
            yield dict(x=np.full((1,) + SHAPE + (4,), i, np.float32),
                       target=tgt[None].astype(np.int64), name=[f"c{i}"])

    _assert_same(_both_branches(monkeypatch, tmp_path, loader,
                                _FixedSweep(volumes)))


def test_device_branch_with_the_sweep_engine(monkeypatch, tmp_path):
    """The sweep engine's own labels (a small mmFormer on two synthetic
    cases) through both branches."""
    root = tmp_path / "data"
    make_synthetic_dataset(str(root), n_cases=6, shape=(24, 24, 20), seed=3)
    model = init_model(get_model("mmformer", patch_size=16, basic_dims=4,
                                 trans_dim=32, mlp_dim=64, heads=4), seed=2)
    engine = SlidingWindowSweep(model, 4, 16, window_batch=4,
                                compute_dtype=torch.float32, device="cpu")

    def loader():
        return CaseLoader(BratsTest(TEST_TRANSFORMS, root=str(root)))

    out = _both_branches(monkeypatch, tmp_path, loader, engine)
    _assert_same(out)
    for a, b in zip(out["host"][4].labels, out["device"][4].labels):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
