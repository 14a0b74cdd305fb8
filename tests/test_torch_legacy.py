"""The port's host-side remainder against the JAX package, on the inputs
of tests/test_legacy_and_samplers.py: every legacy loss (float32, the
port's (B, C, H, W, Z) against JAX's channels-last, rtol 1e-5), the
samplers (the same streams for the same seeds), `get_temperature`,
`record_loss` and the config helpers (`str2bool`, `AttrDict`,
`parse_value`, `load_yaml_config`)."""

import numpy as np
import pytest
import torch

from passion_tpu import config as jconfig
from passion_tpu import logging_utils as jlog
from passion_tpu import losses_legacy as JL
from passion_tpu.data import samplers as jsamplers
from passion_tpu.engine import schedule as jsched
from passion_tpu_torch import config as tconfig
from passion_tpu_torch import logging_utils as tlog
from passion_tpu_torch import losses_legacy as TL
from passion_tpu_torch.data import samplers as tsamplers
from passion_tpu_torch.engine import schedule as tsched

torch.set_num_threads(2)
SHAPE = (2, 6, 5, 4)  # B, H, W, Z


def _probs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def _cf(a):  # channels-last numpy -> channels-first torch
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _close(got, ref, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=1e-7)


def test_softmax_loss_matches_jax():
    rng = np.random.default_rng(7)
    probs = _probs(rng, SHAPE + (5,))
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=SHAPE)]
    for c in (5, 3):
        _close(TL.softmax_loss(_cf(probs), _cf(onehot), num_cls=c),
               JL.softmax_loss(probs, onehot, num_cls=c))


@pytest.mark.parametrize("gamma", [2.0, 0.5])
def test_focal_loss_matches_jax(gamma):
    rng = np.random.default_rng(8)
    logits = rng.standard_normal(SHAPE + (4,)).astype(np.float32)
    labels = rng.choice([0, 1, 2, 4], size=SHAPE)
    _close(TL.focal_loss(_cf(logits), torch.from_numpy(labels), gamma=gamma),
           JL.focal_loss(logits, labels, gamma=gamma))


def test_dice_matches_jax():
    rng = np.random.default_rng(9)
    o = rng.random(SHAPE).astype(np.float32)
    t = (rng.random(SHAPE) > 0.5).astype(np.float32)
    _close(TL.dice(torch.from_numpy(o), torch.from_numpy(t)), JL.dice(o, t))
    z = np.zeros(SHAPE, np.float32)
    assert TL.dice(torch.from_numpy(z), torch.from_numpy(z)).item() == 1.0


def test_sigmoid_and_softmax_dice_match_jax():
    rng = np.random.default_rng(10)
    labels = rng.choice([0, 1, 2, 4], size=SHAPE)
    sig = rng.random(SHAPE + (3,)).astype(np.float32)
    soft = _probs(rng, SHAPE + (4,))
    lab = torch.from_numpy(labels)
    _close(TL.sigmoid_dice_loss(_cf(sig), lab),
           JL.sigmoid_dice_loss(sig, labels))
    _close(TL.softmax_dice_loss(_cf(soft), lab),
           JL.softmax_dice_loss(soft, labels))


@pytest.mark.parametrize("absent", [None, 3], ids=["all_present",
                                                   "class_3_absent"])
def test_prototype_pmr_loss_matches_jax(absent):
    rng = np.random.default_rng(11)
    b, h, w, z, cf, ncls = 2, 5, 4, 3, 6, 4
    feats = rng.standard_normal((b, h, w, z, cf)).astype(np.float32)
    lab = rng.integers(0, ncls, size=(b, h, w, z))
    if absent is not None:
        lab[0][lab[0] == absent] = 1  # skipped: not in every sample
    onehot = np.eye(ncls, dtype=np.float32)[lab]
    got = TL.prototype_pmr_loss(_cf(feats), None, _cf(onehot), num_cls=ncls)
    ref = JL.prototype_pmr_loss(feats, feats, onehot, num_cls=ncls)
    for g, r in zip(got, ref):
        _close(g, r, rtol=2e-5)


def test_js_div_matches_jax():
    rng = np.random.default_rng(12)
    p = rng.random((3, 4, 5)).astype(np.float32) + 0.1
    q = rng.random((3, 4, 5)).astype(np.float32) + 0.1
    _close(TL.js_div(torch.from_numpy(p), torch.from_numpy(q)),
           JL.js_div(p, q))


def test_mutual_learning_loss_matches_jax():
    rng = np.random.default_rng(13)
    feats = [rng.random((3, 4, 5, 2, 2)).astype(np.float32) + 0.1
             for _ in range(2)]
    mask = np.array([[1, 1, 1, 0], [1, 0, 0, 0], [0, 1, 0, 1]], bool)
    got = TL.mutual_learning_loss([torch.from_numpy(f) for f in feats], mask)
    assert got.shape == (3,) and got[1].item() == 0.0
    _close(got, JL.mutual_learning_loss(feats, mask))


def test_random_cycle_iter_matches_jax():
    a = tsamplers.RandomCycleIter(range(5), seed=0)
    b = jsamplers.RandomCycleIter(range(5), seed=0)
    assert [next(a) for _ in range(23)] == [next(b) for _ in range(23)]


def test_msampler_matches_jax():
    kw = dict(batch_sizes=[3, 1], sizes=[9, 4], num_iters=8, seed=1)
    assert list(tsamplers.MSampler(**kw)) == list(jsamplers.MSampler(**kw))
    assert len(tsamplers.MSampler(**kw)) == 32


def test_cycle_and_random_samplers_match_jax():
    assert list(tsamplers.CycleSampler(4, num_samples=10, seed=0)) == list(
        jsamplers.CycleSampler(4, num_samples=10, seed=0))
    assert len(tsamplers.CycleSampler(6, num_epochs=3, seed=0)) == 18
    a = tsamplers.RandomSampler(list(range(12)), seed=3)
    b = jsamplers.RandomSampler(list(range(12)), seed=3)
    assert list(a) == list(b)
    state = a.get_state()
    nxt = list(a)
    assert list(tsamplers.RandomSampler(list(range(12)), state=state,
                                        seed=999)) == nxt == list(b)


def test_get_temperature_matches_jax():
    for e in (0, 1, 15, 29, 30, 299):
        assert tsched.get_temperature(e) == jsched.get_temperature(e)
    assert [tsched.get_temperature(e) for e in (0, 29, 30)] == [30, 1, 1]


class _Writer:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, global_step):
        self.rows.append((tag, value, global_step))


def test_record_loss_matches_jax():
    table = np.array([[1, 0, 0, 0], [1, 1, 0, 0]], bool)
    masks = np.array([[1, 1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0]], bool)
    losses = [np.array([0.5, 0.25, 9.0]), torch.tensor([2.0, 4.0, 9.0])]
    tw, jw = _Writer(), _Writer()
    kw = dict(step=7, mask_table=table, mask_names=["t1", "t1ce"],
              p_types=["idt", "pdt", "idt"])
    tlog.record_loss(tw, masks, losses, ["dice", "ce"], **kw)
    jlog.record_loss(jw, masks, [np.asarray(v) for v in losses],
                     ["dice", "ce"], **kw)
    assert tw.rows == jw.rows == [
        ("idt_t1ce_dice", 0.5, 7), ("idt_t1ce_ce", 2.0, 7),
        ("pdt_t1_dice", 0.25, 7), ("pdt_t1_ce", 4.0, 7)]


@pytest.mark.parametrize("s", ["yes", "True", "T", "y", "1", "no", "False",
                               "f", "N", "0", "maybe"])
def test_str2bool_matches_jax(s):
    try:
        want = jconfig.str2bool(s)
    except ValueError:
        with pytest.raises(ValueError):
            tconfig.str2bool(s)
        return
    assert tconfig.str2bool(s) is want


def test_attrdict_and_parse_value_match_jax():
    for mod in (tconfig, jconfig):
        d = mod.AttrDict()
        d.a.b = 3
        d.merge({"a": {"c": 4}, "e": {"f": 5}})
        assert d.a.b == 3 and d.a.c == 4 and d.e.f == 5
        assert isinstance(d.e, mod.AttrDict)
        with pytest.raises(AttributeError):
            getattr(d, "__missing_dunder__")
    for v in ("(1, 2)", "3/4", "hello", "[1, 'a']", "2e-4", {"k": "1/2"}, 7):
        assert tconfig.parse_value(v) == jconfig.parse_value(v)


def test_load_yaml_config_matches_jax(tmp_path):
    f = tmp_path / "cfg.yaml"
    f.write_text("model: mmformer\nopt:\n  lr: '2e-4'\n  betas: "
                 "'(0.9, 0.999)'\n  frac: 1/3\n")
    got = tconfig.load_yaml_config(str(f))
    assert got == jconfig.load_yaml_config(str(f))
    assert got.opt.lr == 2e-4 and got.opt.betas == (0.9, 0.999)
    assert isinstance(got.opt, tconfig.AttrDict)
