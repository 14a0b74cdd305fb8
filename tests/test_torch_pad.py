"""passion_tpu_torch.ops.pad on the CPU: the plain reflect pad against
numpy and against the JAX package's `jnp.pad(mode="reflect")`, K6's index
arithmetic (`reflect_index`, its division by magic numbers and its walk
over each thread's run of the flat output, transcribed from
csrc/reflect_pad.cu) against numpy's indices, the wrapper's routes (the
plain version on the CPU and under autograd), its launch count, its byte
count (a view's copy included), the dtypes the kernel is built for, and
what it refuses. The kernel itself runs on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 3c)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from passion_tpu_torch import roofline
from passion_tpu_torch.ops import pad

torch.set_num_threads(2)
SIZES = (1, 2, 3, 5, 8)
OTHER = (4, 3)  # the two other axes' sizes beside the axis under test


def _np_pad(a: np.ndarray, p: int) -> np.ndarray:
    return np.pad(a, ((0, 0), (0, 0)) + ((p, p),) * 3, mode="reflect")


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's raw bits (bf16 has no numpy dtype)."""
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.float64: torch.int64}[t.dtype]).numpy()


def _inputs(size: int, dtype) -> list[torch.Tensor]:
    """(2, 3, ...) inputs with `size` on each spatial axis in turn."""
    rng = np.random.default_rng(size)
    out = []
    for axis in range(3):
        spatial = list(OTHER)
        spatial.insert(axis, size)
        a = rng.standard_normal((2, 3, *spatial)).astype(np.float32)
        out.append(torch.from_numpy(a).to(dtype))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64], ids=["f32", "bf16", "f64"])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_plain_equals_numpy(size, p, dtype):
    """Bit for bit, pad >= size included (numpy's periodic indices)."""
    for x in _inputs(size, dtype):
        got = pad.reflect_pad3d_plain(x, p)
        np.testing.assert_array_equal(_bits(got), _np_pad(_bits(x), p))


@pytest.mark.parametrize("p", [1, 2, 3])
def test_wrapper_equals_jnp_pad(p):
    """The port's wrapper (the plain version on the CPU) against the JAX
    package's pad, `jnp.pad(mode="reflect")` on the spatial axes, at the
    small models' shapes: the 1- and 2-voxel bottlenecks of 16- and
    32-voxel patches, and a 5-voxel one."""
    rng = np.random.default_rng(p)
    for spatial in ((1, 1, 1), (2, 2, 2), (5, 5, 5), (4, 3, 1)):
        a = rng.standard_normal((2, 6, *spatial)).astype(np.float32)
        want = np.asarray(jnp.pad(jnp.asarray(a), ((0, 0), (0, 0)) +
                                  ((p, p),) * 3, mode="reflect"))
        got = pad.reflect_pad3d(torch.from_numpy(a), p).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", range(1, 10))
def test_reflect_index_equals_numpy(n):
    """K6's periodic reflect index gives numpy's for pads up to 3 x size."""
    for p in range(3 * n + 1):
        want = np.pad(np.arange(n), p, mode="reflect")
        got = [pad.reflect_index(o - p, n) for o in range(n + 2 * p)]
        assert got == want.tolist(), (n, p)


def _magic(d: int) -> tuple[int, int]:
    """`make_div` of csrc/reflect_pad.cu: (magic, shift)."""
    shift = 0
    while (1 << shift) < d:
        shift += 1
    magic = ((1 << 32) * ((1 << shift) - d)) // d + 1
    assert 0 < magic < 1 << 32
    return magic, shift


def _divide(n: int, ms: tuple[int, int]) -> int:
    """`divide` of csrc/reflect_pad.cu: (umulhi(n, magic) + n) >> shift in
    32-bit arithmetic."""
    magic, shift = ms
    t = (n * magic) >> 32
    assert t + n < 1 << 32  # no wrap for n < 2^31
    return (t + n) >> shift


@pytest.mark.parametrize("d", [1, 2, 3, 7, 82, 82 * 82, 82 ** 3, 7 ** 3,
                               42 ** 3, 3 * 4 * 5, 2 ** 31 - 1])
def test_magic_division_is_exact(d):
    """Every padded extent's division, on numerators up to 2^31 - 1 (the
    most output elements a launch indexes)."""
    ms = _magic(d)
    rng = np.random.default_rng(d)
    k = rng.integers(0, 2 ** 31 // d, 500)
    ns = np.concatenate([np.arange(200), rng.integers(0, 2 ** 31, 2000),
                         k * d, k * d + d - 1, [2 ** 31 - 1]])
    for n in ns.tolist():
        assert _divide(n, ms) == n // d, n


def _k6_walk(x: np.ndarray, p: int, vec: int) -> np.ndarray:
    """`reflect_pad3d_kernel` of csrc/reflect_pad.cu, transcribed: every
    thread's run of `vec` flat output elements, its 32-bit decomposition by
    magic numbers, the interior run, the halo run from two row bases
    (`two_rows`) and the element walk."""
    n, c, dd, hh, ww = x.shape
    dp, hp, wp = dd + 2 * p, hh + 2 * p, ww + 2 * p
    out_plane, in_plane = dp * hp * wp, dd * hh * ww
    total = n * c * out_plane
    div_plane, div_hw, div_w = _magic(out_plane), _magic(hp * wp), _magic(wp)
    two_rows = p < dd and p < hh and p < ww and wp >= vec
    xf, y = x.reshape(-1), np.zeros(total, x.dtype)

    def row_of(d, h):
        return (pad.reflect_index(d - p, dd) * hh
                + pad.reflect_index(h - p, hh)) * ww

    for e0 in range(0, total, vec):
        plane = _divide(e0, div_plane)
        r = e0 - plane * out_plane
        d = _divide(r, div_hw)
        r -= d * hp * wp
        h = _divide(r, div_w)
        w = r - h * wp
        src = plane * in_plane
        row = src + row_of(d, h)
        whole = e0 + vec <= total
        if whole and w >= p and w + vec <= ww + p:
            v = xf[row + w - p:row + w - p + vec].tolist()
        elif two_rows:
            h1, d1, src1 = h + 1, d, src
            if h1 == hp:
                h1, d1 = 0, d1 + 1
                if d1 == dp:
                    d1, src1 = 0, src1 + in_plane
            row1 = src1 + row_of(d1, h1)
            v = []
            for k in range(vec):
                nxt = w + k >= wp
                i = (w + k - wp if nxt else w + k) - p
                i = -i if i < 0 else (2 * (ww - 1) - i if i >= ww else i)
                v.append(xf[(row1 if nxt else row) + i]
                         if e0 + k < total else 0)
        else:
            v = []
            for k in range(vec):
                v.append(xf[row + pad.reflect_index(w - p, ww)]
                         if e0 + k < total else 0)
                w += 1
                if w == wp:
                    w, h = 0, h + 1
                    if h == hp:
                        h, d = 0, d + 1
                        if d == dp:
                            d, src = 0, src + in_plane
                    row = src + row_of(d, h)
        y[e0:e0 + vec] = v[:total - e0]
    return y.reshape(n, c, dp, hp, wp)


@pytest.mark.parametrize("vec", [8, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,p", [((1, 8, 1, 2, 3), 1),
                                     ((2, 3, 1, 1, 1), 1),
                                     ((1, 2, 5, 4, 3), 2),
                                     ((2, 1, 6, 6, 6), 1),
                                     ((1, 2, 9, 7, 10), 1),
                                     ((3, 1, 4, 5, 6), 2),
                                     ((1, 3, 2, 3, 2), 4)])
def test_kernel_walk_equals_numpy(shape, p, vec):
    """Runs that cross rows, planes and the end of the output, by both
    halo paths, and pads beyond the size, in both dtypes' run lengths."""
    x = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
    np.testing.assert_array_equal(_k6_walk(x, p, vec), _np_pad(x, p))


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    x = torch.randn(2, 4, 5, 6, 7)
    before = pad.reflect_pad3d.launches
    got = pad.reflect_pad3d(x, 1)
    assert pad.reflect_pad3d.launches == before
    assert torch.equal(got, F.pad(x, (1,) * 6, mode="reflect"))


@pytest.mark.parametrize("spatial", [(5, 6, 7), (1, 2, 3)])
def test_autograd_takes_the_plain_version(monkeypatch, spatial):
    """With a gradient to carry, the wrapper pads with autograd's own pad
    (the byte counter and the kernel are never asked), and the gradient
    is F.pad's (numpy's indices on a short axis)."""
    monkeypatch.setattr(pad, "_padded", None)  # the kernel path's checks
    x0 = torch.randn(2, 3, *spatial, dtype=torch.float64)
    w = torch.randn(2, 3, *(s + 2 for s in spatial), dtype=torch.float64)
    x = x0.clone().requires_grad_()
    (g,) = torch.autograd.grad((pad.reflect_pad3d(x, 1) * w).sum(), x)
    xp = x0.clone().requires_grad_()
    (gp,) = torch.autograd.grad((pad.reflect_pad3d_plain(xp, 1) * w).sum(),
                                xp)
    torch.testing.assert_close(g, gp, rtol=0, atol=0)
    if min(spatial) > 1:
        xf = x0.clone().requires_grad_()
        (gf,) = torch.autograd.grad(
            (F.pad(xf, (1,) * 6, mode="reflect") * w).sum(), xf)
        torch.testing.assert_close(g, gf, rtol=0, atol=0)


def test_no_grad_path_needs_no_gradient_machinery():
    x = torch.randn(1, 2, 3, 3, 3, requires_grad=True)
    with torch.no_grad():
        y = pad.reflect_pad3d(x, 1)
    assert not y.requires_grad
    assert torch.equal(y, F.pad(x.detach(), (1,) * 6, mode="reflect"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("spatial", [(5, 6, 7), (1, 1, 1)])
def test_byte_count_is_x_read_and_y_written(dtype, spatial):
    """Under a counter the wrapper hands K6's bytes (x once, y once) and
    what it runs on the CPU adds nothing."""
    x = torch.randn(2, 3, *spatial).to(dtype)
    out = []
    got = roofline.count(lambda: out.append(pad.reflect_pad3d(x, 1)))
    want = x.nbytes + out[0].nbytes
    assert got == {"flops": 0, "bytes": want,
                   "by_op": {"K6 reflect_pad3d": want}}
    assert torch.equal(out[0], pad.reflect_pad3d_plain(x, 1))
    assert pad.byte_counter is None


def test_counter_sees_k6_whose_launch_it_cannot_see(monkeypatch):
    """On the card K6 is a ctypes call that no dispatch mode sees. A stub
    in the kernel's place that writes y outside torch's dispatch shows
    that the counter still records the bytes, under K6's name: it takes
    them from the wrapper, not from the launch."""
    ran = []

    def stub(x, p):
        ran.append(tuple(x.shape))
        return torch.from_numpy(_np_pad(x.numpy(), p))

    monkeypatch.setattr(pad, "reflect_pad3d_plain", stub)
    x = torch.randn(2, 4, 3, 5, 6)
    out = []
    got = roofline.count(lambda: out.append(pad.reflect_pad3d(x, 2)))
    assert ran == [(2, 4, 3, 5, 6)]
    want = x.nbytes + 2 * 4 * 7 * 9 * 10 * 4
    assert got["by_op"] == {"K6 reflect_pad3d": want}
    assert got["bytes"] == want
    np.testing.assert_array_equal(out[0].numpy(), _np_pad(x.numpy(), 2))


def test_kernel_has_a_width_for_every_dtype_the_wrapper_takes():
    """The wrapper's dtype codes against the kernel's C entry point: each
    code dispatches to an instantiation whose word is the dtype's width
    (K6 copies raw words), so float64 (a float64 step pads its raw image
    off autograd) launches on the card like bf16 and float32."""
    import re
    from pathlib import Path

    src = (Path(pad.__file__).parent.parent / "csrc" /
           "reflect_pad.cu").read_text()
    width = {"uint16_t": 2, "uint32_t": 4, "uint64_t": 8}
    dispatch = {int(code): width[word] for code, word in re.findall(
        r"if \(dtype == (\d+)\) return launch<(\w+)>", src)}
    assert dispatch == {code: dt.itemsize
                        for dt, code in pad._DTYPE_CODE.items()}
    assert set(pad._DTYPE_CODE) == {torch.float32, torch.bfloat16,
                                    torch.float64}


@pytest.mark.parametrize("layout", ["channels_last", "transposed"])
def test_a_view_is_padded_and_counted_with_its_copy(layout):
    """A view (the channels-last fusion tokens of M2FTrans's bottleneck)
    pads as F.pad pads it; K6 reads a contiguous tensor, so on the card the
    wrapper copies the view first, and the counter adds the copy's bytes
    (x read and written once more) on either device."""
    x0 = torch.randn(2, 4, 3, 5, 6)
    if layout == "channels_last":
        x = x0.permute(0, 2, 3, 4, 1).contiguous().permute(0, 4, 1, 2, 3)
    else:
        x = x0.transpose(2, 3)
    assert not x.is_contiguous()
    out = []
    counted = roofline.count(lambda: out.append(pad.reflect_pad3d(x, 1)))
    assert torch.equal(out[0], F.pad(x, (1,) * 6, mode="reflect"))
    want = 3 * x.nbytes + out[0].nbytes
    assert counted == {"flops": 0, "bytes": want,
                       "by_op": {"K6 reflect_pad3d": want}}


@pytest.mark.parametrize("bad", ["float16", "4d",
                                 "negative_pad", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, p = torch.randn(2, 4, 3, 3, 3), 1
    if bad == "float16":
        x = x.half()
    elif bad == "4d":
        x = x[0]
    elif bad == "negative_pad":
        p = -1
    elif bad == "meta_device":
        x = x.to("meta")
    with pytest.raises((ValueError, TypeError)):
        pad.reflect_pad3d(x, p)
