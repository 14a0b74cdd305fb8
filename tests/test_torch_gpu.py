"""The port's CUDA kernels on a card: K1 + K2 (forward) and K3 + K4
(backward) against their plain PyTorch version, at the row shapes of all
three backbones, the autograd Function's gradient against autograd of the
plain forward, K6 (the reflect pad) bit for bit at the sweeps' shapes, K5
(the distance transform) exactly, and the models' kernel path against
their plain-norm path, for inference (mmFormer, RFNet, M2FTrans), the
single-mask engine, the validation step and one train step (mmFormer).
Marked `gpu`; each test decides inside itself whether a card is present
and skips without one. This file imports torch and the port only (a GPU
machine need not have JAX), so it runs there without tests/conftest.py,
which imports JAX:

  python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

from passion_tpu_torch.ops import fused_norm as tfn

pytestmark = pytest.mark.gpu
torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest "
                    "tests/test_torch_gpu.py -m gpu --noconftest` on the card "
                    "(README, PyTorch/CUDA port)")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    # float32 comparisons run in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


@pytest.mark.parametrize("shape,dtype,pg", [
    ((2, 32, 80, 80, 80), torch.bfloat16, 1),  # sweep scale 1
    ((2, 64, 40, 40, 40), torch.bfloat16, 1),  # scale 2
    ((2, 128, 20, 20, 20), torch.bfloat16, 1),  # scale 3
    ((2, 2, 80, 80, 80), torch.bfloat16, 1),  # RFNet's PRM embedding
    ((2, 256, 10, 10, 10), torch.bfloat16, 1),  # RFNet's deepest scale
    ((2, 64, 20, 20, 20), torch.bfloat16, 8),  # phase_group 8
    ((2, 512, 5, 5, 5), torch.bfloat16, 1),  # M2FTrans's fifth scale
    ((2, 512, 5, 5, 5), torch.float32, 1),  # 125-element rows: scalar path
])
def test_kernels_match_plain(card, shape, dtype, pg):
    x = (torch.randn(shape, generator=card, device="cuda") * 3 + 1).to(dtype)
    k1, k2 = tfn.norm_stats.launches, tfn.norm_apply.launches
    st = tfn.norm_stats(x, phase_group=pg)
    y = tfn.norm_apply(x, st, phase_group=pg)
    torch.cuda.synchronize()
    assert (tfn.norm_stats.launches, tfn.norm_apply.launches) == (k1 + 1,
                                                                  k2 + 1)
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(st, tfn.norm_stats_plain(x, phase_group=pg),
                               rtol=1e-4, atol=1e-5)
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(
        y.float(), tfn.instance_norm_lrelu_plain(x, phase_group=pg).float(),
        rtol=1e-2, atol=atol)


def test_large_mean_against_float64(card):
    """|mean| >> std at the bound the TPU kernel met (tests/test_ops.py)."""
    x64 = torch.randn((1, 128, 40, 40, 40), generator=card, device="cuda",
                      dtype=torch.float64) * 0.5 + 50.0
    m = x64.mean(dim=(2, 3, 4), keepdim=True)
    v = ((x64 - m) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    y64 = (x64 - m) / torch.sqrt(v + 1e-5)
    y64 = torch.where(y64 >= 0, y64, 0.2 * y64)
    got = tfn.instance_norm_lrelu(x64.float()).double()
    torch.testing.assert_close(got, y64, rtol=1e-4, atol=5e-5)


def test_runs_repeat_bit_for_bit(card):
    x = torch.randn((3, 64, 40, 40, 40), generator=card, device="cuda",
                    dtype=torch.bfloat16)
    a = tfn.instance_norm_lrelu(x)
    b = tfn.instance_norm_lrelu(x)
    assert torch.equal(a, b)


def test_model_kernel_path_matches_plain_norm(card, monkeypatch):
    """A small mmFormer on the card in float32: every norm site through
    K1 + K2 against the same model with the plain norm (atol 1e-4), and
    the sweep's premasked split against the plain forward."""
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model

    net = init_model(get_model("mmformer", patch_size=16, basic_dims=4,
                               trans_dim=32, mlp_dim=64, heads=4), seed=0)
    net = net.to("cuda").eval()
    x = torch.randn((2, 4, 16, 16, 16), generator=card, device="cuda")
    mask = torch.as_tensor(np.stack([MASK_ARRAY[9]] * 2), device="cuda")
    with torch.inference_mode():
        k1 = tfn.norm_stats.launches
        got = net.fuse_inference(net.features(x), mask)
        assert tfn.norm_stats.launches - k1 == 18 + 23
        fwd = net(x, mask)
        monkeypatch.setattr(tfn, "instance_norm_lrelu",
                            tfn.instance_norm_lrelu_plain)
        ref = net.fuse_inference(net.features(x), mask)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(got, fwd, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,kw,patch,sites", [
    ("rfnet", dict(basic_dims=4), 16, 12 + 49),
    ("m2ftrans", dict(basic_dims=2, heads=4, mlp_dim=32, depth=2), 32,
     15 + 28),
])
def test_backbone_kernel_path_matches_plain_norm(card, monkeypatch, name,
                                                 kw, patch, sites):
    """A small RFNet / M2FTrans on the card in float32: the sweep's
    `fuse_inference(features)` through K1 + K2 against the plain norm
    (atol 1e-4) and against the plain forward."""
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model

    net = init_model(get_model(name, patch_size=patch, **kw), seed=0)
    net = net.to("cuda").eval()
    x = torch.randn((2, 4, patch, patch, patch), generator=card,
                    device="cuda")
    mask = torch.as_tensor(np.stack([MASK_ARRAY[9]] * 2), device="cuda")
    with torch.inference_mode():
        k1 = tfn.norm_stats.launches
        got = net.fuse_inference(net.features(x), mask)
        assert tfn.norm_stats.launches - k1 == sites
        fwd = net(x, mask)
        monkeypatch.setattr(tfn, "instance_norm_lrelu",
                            tfn.instance_norm_lrelu_plain)
        ref = net.fuse_inference(net.features(x), mask)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(got, fwd, rtol=0, atol=1e-5)


def _ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 bits of mantissa), at least the smallest
    normal's."""
    e = torch.floor(torch.log2(v.abs().float().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("shape,dtype,pg", [
    ((5, 32, 80, 80, 80), torch.bfloat16, 1),  # fuse lanes, scale 1
    ((4, 16, 40, 40, 40), torch.bfloat16, 1),  # sep decoder, scale 2
    ((5, 2, 80, 80, 80), torch.bfloat16, 1),  # RFNet's PRM embedding lanes
    ((2, 512, 5, 5, 5), torch.bfloat16, 1),  # RFM5 rows: scalar path
    ((2, 64, 20, 20, 20), torch.float32, 8),  # phase_group 8
    ((2, 512, 5, 5, 5), torch.float32, 1),
])
def test_backward_kernels_match_plain(card, shape, dtype, pg):
    x = (torch.randn(shape, generator=card, device="cuda") * 3 + 1).to(dtype)
    g = torch.randn(shape, generator=card, device="cuda").to(dtype)
    st = tfn.norm_stats(x, phase_group=pg)
    k3, k4 = tfn.norm_bwd_stats.launches, tfn.norm_bwd_apply.launches
    b = tfn.norm_bwd_stats(x, g, st, phase_group=pg)
    dx = tfn.norm_bwd_apply(x, g, st, b, phase_group=pg)
    torch.cuda.synchronize()
    assert (tfn.norm_bwd_stats.launches, tfn.norm_bwd_apply.launches) == (
        k3 + 1, k4 + 1)
    b_p = tfn.norm_bwd_stats_plain(x, g, st, phase_group=pg)
    torch.testing.assert_close(b, b_p, rtol=1e-4, atol=1e-5)
    # with the same row statistics, dx differs by the float rounding of
    # the two orders of operation, then one rounding to x's dtype
    dx_p = tfn.norm_bwd_apply_plain(x, g, st, b, phase_group=pg)
    if dtype == torch.bfloat16:
        assert ((dx.float() - dx_p.float()).abs()
                <= _ulp_bf16(dx_p) + 1e-6).all()
    else:
        torch.testing.assert_close(dx, dx_p, rtol=1e-5, atol=1e-5)


def test_autograd_gradient_matches_plain_autograd(card):
    """float32: the Function's K3 + K4 gradient against torch.autograd of
    the plain forward."""
    x = (torch.randn((3, 32, 24, 24, 24), generator=card, device="cuda") * 2
         + 0.5).requires_grad_()
    w = torch.randn(x.shape, generator=card, device="cuda")
    (gk,) = torch.autograd.grad((tfn.instance_norm_lrelu(x) * w).sum(), x)
    (gp,) = torch.autograd.grad((tfn.instance_norm_lrelu_plain(x) * w).sum(),
                                x)
    torch.testing.assert_close(gk, gp, rtol=1e-4, atol=1e-4)


def test_train_step_kernel_path_matches_plain_norm(card, monkeypatch):
    """One float32 train step of a small mmFormer: loss and updated params
    through K1-K4 against the same step with the plain norm."""
    from passion_tpu_torch.engine import schedule, train_loop
    from passion_tpu_torch.models import get_model, init_model

    def run():
        net = init_model(get_model("mmformer", patch_size=32, basic_dims=4,
                                   trans_dim=32, mlp_dim=64, heads=4),
                         seed=0).to("cuda")
        opt = schedule.make_optimizer(net.parameters())
        schedule.set_learning_rate(opt, 2e-4)
        step = train_loop.make_train_step(net, opt, True, compute_dtype=None)
        gen = torch.Generator(device="cuda").manual_seed(1)
        labels = torch.randint(0, 4, (2, 32, 32, 32), generator=gen,
                               device="cuda")
        batch = dict(
            x=torch.randn((2, 4, 32, 32, 32), generator=gen, device="cuda"),
            target=torch.nn.functional.one_hot(labels, 4).permute(
                0, 4, 1, 2, 3).float().contiguous(),
            mask=torch.tensor([[1, 1, 1, 1], [1, 0, 1, 0]], dtype=torch.bool,
                              device="cuda"))
        m = step(batch, torch.ones(4, device="cuda"),
                 torch.ones(4, device="cuda"), 4.0)
        return m, net

    k3 = tfn.norm_bwd_stats.launches
    m_k, net_k = run()
    assert tfn.norm_bwd_stats.launches > k3
    monkeypatch.setattr(tfn, "instance_norm_lrelu",
                        tfn.instance_norm_lrelu_plain)
    m_p, net_p = run()
    torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=1e-4,
                               atol=1e-5)
    for (name, a), b in zip(net_k.named_parameters(), net_p.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-4, msg=name)


def test_single_mask_engine_kernel_path_matches_plain_norm(card,
                                                           monkeypatch):
    """The single-mask engine (the whole `forward` per chunk) of a small
    mmFormer in float32 on the card: K1 + K2 at every one of forward's
    14 + 27 norm sites per chunk, probabilities against the plain norm's
    (atol 1e-4), labels against the sweep engine's."""
    from passion_tpu_torch.engine.sliding_window import (
        SlidingWindowInference, SlidingWindowSweep)
    from passion_tpu_torch.masks import MASK_ARRAY
    from passion_tpu_torch.models import get_model, init_model

    net = init_model(get_model("mmformer", patch_size=16, basic_dims=4,
                               trans_dim=32, mlp_dim=64, heads=4), seed=0)
    vol = np.random.default_rng(0).standard_normal((24, 24, 20, 4)).astype(
        np.float32)
    eng = SlidingWindowInference(net, 4, 16, window_batch=3,
                                 compute_dtype=torch.float32)
    prepared = eng.prepare(vol)
    k1 = tfn.norm_stats.launches
    got = eng.run(prepared, MASK_ARRAY[9])
    assert tfn.norm_stats.launches - k1 == 3 * (14 + 27)  # 3 chunks
    sweep = SlidingWindowSweep(net, 4, 16, window_batch=3,
                               compute_dtype=torch.float32)
    torch.testing.assert_close(
        torch.from_numpy(eng.infer_labels(prepared, MASK_ARRAY[9])),
        torch.from_numpy(sweep.sweep_labels(sweep.prepare(vol),
                                            [MASK_ARRAY[9]])[0]))
    monkeypatch.setattr(tfn, "instance_norm_lrelu",
                        tfn.instance_norm_lrelu_plain)
    torch.testing.assert_close(got, eng.run(prepared, MASK_ARRAY[9]),
                               rtol=0, atol=1e-4)


def test_val_step_kernel_path_matches_plain_norm(card, monkeypatch):
    """The validation step of a small mmFormer in float32 on the card:
    K1 + K2 at the training forward's 53 norm sites, no K3/K4, the loss
    against the plain norm's (rtol 1e-4)."""
    from passion_tpu_torch.engine import train_loop
    from passion_tpu_torch.models import get_model, init_model

    net = init_model(get_model("mmformer", patch_size=32, basic_dims=4,
                               trans_dim=32, mlp_dim=64, heads=4),
                     seed=0).to("cuda")
    step = train_loop.make_val_step(net, 4, compute_dtype=None)
    labels = torch.randint(0, 4, (2, 32, 32, 32), generator=card,
                           device="cuda")
    x = torch.randn((2, 4, 32, 32, 32), generator=card, device="cuda")
    target = torch.nn.functional.one_hot(labels, 4).permute(
        0, 4, 1, 2, 3).float().contiguous()
    mask = torch.tensor([[1, 1, 1, 1], [1, 0, 1, 0]], dtype=torch.bool,
                        device="cuda")
    k1, k3 = tfn.norm_stats.launches, tfn.norm_bwd_stats.launches
    got = step(x, mask, target, 4.0)
    assert tfn.norm_stats.launches - k1 == 14 + 27 + 12
    assert tfn.norm_bwd_stats.launches == k3
    monkeypatch.setattr(tfn, "instance_norm_lrelu",
                        tfn.instance_norm_lrelu_plain)
    torch.testing.assert_close(got, step(x, mask, target, 4.0), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kernel", range(4))
def test_byte_counts_on_the_card_equal_the_cpus(card, kernel):
    """Under `roofline.ByteCounter` each wrapper launches its kernel once
    and counts its own operands, as its plain version does on the CPU."""
    from passion_tpu_torch import roofline

    x = (torch.randn((2, 32, 20, 20, 20), generator=card, device="cuda")
         * 3 + 1).to(torch.bfloat16)
    g = torch.randn(x.shape, generator=card, device="cuda").to(x.dtype)
    st = tfn.norm_stats_plain(x)
    bst = tfn.norm_bwd_stats_plain(x, g, st)
    args = [(x,), (x, st), (x, g, st), (x, g, st, bst)][kernel]
    wrapper = tfn.WRAPPERS[kernel]
    before = wrapper.launches
    on_card = roofline.count(lambda: wrapper(*args))
    host = [t.cpu() for t in args]
    on_cpu = roofline.count(lambda: wrapper(*host))
    assert wrapper.launches == before + 1
    assert on_card == on_cpu and on_card["bytes"] > x.nbytes


def test_trace_reports_every_kernel_of_the_call(card, tmp_path):
    """`profile.trace` of a call on the card: its kernel table agrees with
    its chrome trace and holds the call's three launches, not the warm-up
    step's kernels."""
    from passion_tpu_torch import profile

    x = torch.randn((4, 32, 40, 40, 40), generator=card, device="cuda")
    t = profile.trace(lambda: tfn.instance_norm_lrelu(x),
                      str(tmp_path / "t.json"))
    got = profile.report_trace(t, "norm", "card")
    assert got["calls"] == 3  # K1's two launches, K2
    assert got["busy_ms"] == pytest.approx(got["chrome_ms"], rel=0.01)
    assert 0 < got["busy_ms"] <= t["event_ms"] * 1.05


# K6's shapes (chip_smoke.py phase 3c): the sweeps' pad inputs at a
# window batch of 75, one float32 shape, and axes shorter than the pad
PAD_CASES = [((75, 32, 80, 80, 80), torch.bfloat16, 1),
             ((75, 16, 80, 80, 80), torch.bfloat16, 1),
             ((75, 64, 40, 40, 40), torch.bfloat16, 1),
             ((75, 512, 5, 5, 5), torch.bfloat16, 1),
             ((4, 32, 80, 80, 80), torch.float32, 1),
             ((1, 8, 1, 2, 3), torch.bfloat16, 1),
             ((2, 3, 1, 1, 1), torch.float32, 1),
             ((2, 3, 5, 4, 3), torch.bfloat16, 4),
             ((1, 4, 80, 80, 80), torch.float64, 1),
             ((2, 3, 1, 2, 3), torch.float64, 2)]


@pytest.mark.parametrize("shape,dtype,p", PAD_CASES)
def test_reflect_pad_matches_plain_bit_for_bit(card, shape, dtype, p):
    """K6 launches once and equals its plain version (F.pad, or numpy's
    indices on a short axis) bit for bit: it is a copy."""
    from passion_tpu_torch.ops import pad

    x = torch.randn(shape, generator=card, device="cuda").to(dtype)
    before = pad.reflect_pad3d.launches
    with torch.inference_mode():
        got = pad.reflect_pad3d(x, p)
    torch.cuda.synchronize()
    assert pad.reflect_pad3d.launches == before + 1
    assert torch.equal(got, pad.reflect_pad3d_plain(x, p))


def test_reflect_pad_routes_on_the_card(card):
    """Under autograd the wrapper pads with autograd's own pad (no
    launch); a view (M2FTrans's channels-last fusion tokens) launches K6
    on its copy and equals the plain version; the byte count equals the
    CPU's."""
    from passion_tpu_torch import roofline
    from passion_tpu_torch.ops import pad

    x = torch.randn((2, 4, 6, 7, 8), generator=card, device="cuda")
    before = pad.reflect_pad3d.launches
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(pad.reflect_pad3d(xg, 1).sum(), xg)
    assert pad.reflect_pad3d.launches == before
    assert g.shape == x.shape
    view = x.permute(0, 2, 3, 4, 1).contiguous().permute(0, 4, 1, 2, 3)
    assert not view.is_contiguous()
    with torch.inference_mode():
        got = pad.reflect_pad3d(view, 1)
    assert pad.reflect_pad3d.launches == before + 1
    assert torch.equal(got, pad.reflect_pad3d_plain(view, 1))
    on_card = roofline.count(lambda: pad.reflect_pad3d(x, 1))
    assert pad.reflect_pad3d.launches == before + 2
    host = x.cpu()
    assert on_card == roofline.count(lambda: pad.reflect_pad3d(host, 1))


@pytest.mark.parametrize("shape", [(3, 24, 20, 16), (2, 7, 1, 5),
                                   (1, 9, 8, 1), (2, 40, 300, 33),
                                   (2, 5, 240, 234), (1, 4, 300, 126),
                                   (2, 240, 240, 155), (3, 7, 24, 40)])
def test_distance_transform_matches_plain(card, shape):
    """K5 equals its plain version exactly: speckled, face-touching,
    single-voxel, full and empty volumes, each region; lines longer than
    256 (W 300) take the kernel's 16-bit envelope; W x Z planes that only
    just fit pass A's shared memory (240 x 234, 300 x 126); two BraTS
    volumes; and 21 planes, an odd count (pass A takes one plane a
    block)."""
    from passion_tpu_torch.ops import edt

    rng = np.random.default_rng(list(shape))
    lab = rng.integers(0, 4, shape).astype(np.uint8)
    lab[0, rng.random(shape[1:]) < 0.3] = 0
    if shape[0] > 2:
        lab[1] = 2  # full: the border is the volume's faces
        lab[2] = 0
        lab[2, shape[1] // 2, shape[2] // 2, shape[3] // 2] = 3
    x = torch.from_numpy(lab).cuda()
    for classes in ((1, 2, 3), (1, 3), (3,), (5,)):  # (5,): empty
        before = edt.edt_sq.launches
        got = edt.edt_sq(x, classes)
        torch.cuda.synchronize()
        assert edt.edt_sq.launches == before + 1
        assert torch.equal(got.cpu(), edt.edt_sq_plain(x.cpu(), classes))


def test_device_scorer_on_the_card_matches_the_host(card):
    """`metrics.score_masks` on the card against `dice_class4` (bit for
    bit) and `cal_hd95` (1e-9) on a speckled, a clean and an empty
    prediction."""
    from passion_tpu_torch import metrics

    shape = (40, 36, 34)
    grid = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    r2 = sum((g - s // 2) ** 2 for g, s in zip(grid, shape))
    tgt = np.zeros(shape, np.uint8)
    tgt[r2 <= 144] = 2
    tgt[r2 <= 64] = 1
    tgt[r2 <= 36] = 3
    rng = np.random.default_rng(0)
    labels = np.stack([rng.integers(0, 4, shape).astype(np.uint8), tgt,
                       np.roll(tgt, 3, axis=1), np.zeros(shape, np.uint8)])
    dice, hd = metrics.score_masks(torch.from_numpy(labels).cuda(),
                                   torch.from_numpy(tgt).cuda())
    for m in range(len(labels)):
        _, want = metrics.dice_class4(labels[m][None], tgt[None])
        np.testing.assert_array_equal(dice[m], want[0])
        np.testing.assert_allclose(hd[m], metrics.cal_hd95(labels[m], tgt),
                                   rtol=0, atol=1e-9)
