"""Host-side augmentation pipeline (copy of `passion_tpu/data/transforms.py`;
reference code/data/transforms.py). numpy and scipy only, so the same seed
gives the same augmented arrays as the JAX package's loader.

Same two-phase protocol as the reference — randomness is drawn ONCE per call
(`sample`) and then applied consistently to image (k=0) and label (k=1) —
but re-designed stateless: `sample` RETURNS a params object instead of
stashing buffers on `self`, so one transform instance can serve many loader
threads concurrently, and all randomness comes from an explicit
`numpy.random.Generator`.

The reference specifies pipelines as `eval()`'d strings
(code/options.py:50-51, datasets_nii.py:49). `from_string` keeps that public
surface but evaluates in a restricted namespace containing only the transform
classes and numpy dtypes — no arbitrary code.

Tensors are `(1, H, W, Z, C)` images and `(1, H, W, Z)` labels, exactly the
reference's layout.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import rotate

from passion_tpu_torch.data.rand import Constant, Gaussian, Uniform


class Base:
    """Identity transform / base protocol."""

    def sample(self, rng, shape):
        """Draw randomness. Returns (new_shape, params)."""
        del rng
        return list(shape), None

    def apply(self, img, k, params):
        del k, params
        return img

    def __call__(self, imgs, rng):
        """imgs: [image, label] (or a single array)."""
        single = isinstance(imgs, np.ndarray)
        seq = [imgs] if single else list(imgs)
        _, params = self.sample(rng, seq[0].shape[1:4])
        out = [self.apply(x, k, params) for k, x in enumerate(seq)]
        return out[0] if single else out


Identity = Base


class Compose(Base):
    def __init__(self, ops):
        self.ops = list(ops)

    def sample(self, rng, shape):
        params = []
        for op in self.ops:
            shape, p = op.sample(rng, shape)
            params.append(p)
        return shape, params

    def apply(self, img, k, params):
        for op, p in zip(self.ops, params):
            img = op.apply(img, k, p)
        return img

    def __str__(self):
        return "Compose([{}])".format(", ".join(map(str, self.ops)))


class CenterCrop(Base):
    def __init__(self, size):
        self.size = size

    def _start(self, rng, shape, size):
        del rng
        return [(s - i) // 2 for i, s in zip(size, shape)]

    def sample(self, rng, shape):
        size = ([self.size] * 3 if isinstance(self.size, int)
                else list(self.size))
        start = self._start(rng, shape, size)
        sl = tuple([slice(None)] + [slice(s, s + k) for s, k in zip(start, size)])
        return size, sl

    def apply(self, img, k, params):
        del k
        return img[params]


class RandCrop3D(CenterCrop):
    """Random 3D crop (transforms.py:217-229); train default 80^3."""

    def _start(self, rng, shape, size):
        return [int(rng.integers(0, s - i + 1)) for i, s in zip(size, shape)]


RandCrop = RandCrop3D


class RandomRotion(Base):
    """Rotation by a random integer angle about a random axis pair,
    nearest-neighbor, constant fill -1 (transforms.py:86-120)."""

    AXES = [(1, 0), (2, 1), (2, 0)]  # spatial axis pairs (H,W,Z order)

    def __init__(self, angle_spectrum=10):
        self.angle_spectrum = int(angle_spectrum)

    def sample(self, rng, shape):
        axes = self.AXES[int(rng.integers(0, len(self.AXES)))]
        angle = int(rng.integers(-self.angle_spectrum, self.angle_spectrum))
        return list(shape), (axes, angle)

    def apply(self, img, k, params):
        axes, angle = params
        out = np.empty_like(img)
        for bs in range(img.shape[0]):
            if k == 0:
                chans = [rotate(img[bs, ..., c], angle, axes=axes,
                                reshape=False, order=0, mode="constant",
                                cval=-1) for c in range(img.shape[-1])]
                out[bs] = np.stack(chans, axis=-1)
            else:
                out[bs] = rotate(img[bs], angle, axes=axes, reshape=False,
                                 order=0, mode="constant", cval=-1)
        return out


class RandomFlip(Base):
    """Independent coin-flip mirror along each spatial axis
    (transforms.py:133-155)."""

    def __init__(self, axis=0):
        del axis  # reference signature parity; always flips axes (1,2,3)

    def sample(self, rng, shape):
        return list(shape), tuple(bool(rng.integers(0, 2)) for _ in range(3))

    def apply(self, img, k, params):
        del k
        for ax, flip in zip((1, 2, 3), params):
            if flip:
                img = np.flip(img, axis=ax)
        return img


class RandomIntensityChange(Base):
    """Per-(H, C) shift/scale jitter on the image only (transforms.py:232-250).

    Note the reference draws factors of shape [1, H, 1, 1, C] — per
    first-spatial-axis row AND channel — replicated here.
    """

    def __init__(self, factor):
        shift, scale = factor
        assert shift > 0 and scale > 0
        self.shift, self.scale = shift, scale

    def sample(self, rng, shape):
        # factors depend on img shape; store rng draws lazily via closure
        return list(shape), rng

    def apply(self, img, k, params):
        if k == 1:
            return img
        rng = params
        size = [1, img.shape[1], 1, 1, img.shape[4]]
        shift = rng.uniform(-self.shift, self.shift, size=size)
        scale = rng.uniform(1.0 - self.scale, 1.0 + self.scale, size=size)
        return img * scale + shift


class Pad(Base):
    """Zero padding per axis (transforms.py:253-274)."""

    def __init__(self, pad):
        self.pad = pad
        self.px = tuple(zip([0] * len(pad), pad))

    def sample(self, rng, shape):
        del rng
        return [s + p for s, p in zip(shape, self.pad[1:4])], None

    def apply(self, img, k, params):
        del k, params
        return np.pad(img, self.px[: img.ndim], mode="constant")


class Noise(Base):
    """Multiplicative log-normal noise (transforms.py:277-296)."""

    def __init__(self, dim=3, sigma=0.1, channel=True, num=-1):
        self.dim, self.sigma, self.channel, self.num = dim, sigma, channel, num

    def sample(self, rng, shape):
        return list(shape), rng

    def apply(self, img, k, params):
        if self.num > 0 and k >= self.num:
            return img
        rng = params
        shape = ([1] if img.ndim < self.dim + 2 else [img.shape[-1]]) \
            if self.channel else img.shape
        return img * np.exp(self.sigma * rng.standard_normal(shape).astype(np.float32))


class GaussianBlur(Base):
    """Per-volume gaussian blur (transforms.py:300-329; the reference version
    crashes on a missing attribute — fixed here)."""

    def __init__(self, dim=3, sigma=None, app=-1):
        from scipy import ndimage
        self._filter = ndimage.gaussian_filter
        self.dim = dim
        self.sigma = sigma if sigma is not None else Constant(1.5)
        self.eps = 0.001
        self.app = app

    def sample(self, rng, shape):
        return list(shape), rng

    def apply(self, img, k, params):
        if self.app > 0 and k >= self.app:
            return img
        rng = params
        out = img.copy()
        for n in range(img.shape[0]):
            sig = self.sigma.sample(rng)
            if sig > self.eps:
                if img.ndim == self.dim + 2:
                    for c in range(img.shape[-1]):
                        out[n, ..., c] = self._filter(img[n, ..., c], sig)
                else:
                    out[n] = self._filter(img[n], sig)
        return out


class NumpyType(Base):
    """Cast image/label to the k-th dtype (transforms.py:375-388)."""

    def __init__(self, types, num=-1):
        self.types = types
        self.num = num

    def apply(self, img, k, params):
        del params
        if self.num > 0 and k >= self.num:
            return img
        return img.astype(self.types[k])


class ToNumpy(Base):
    """Materialize the k-th item as a host numpy array
    (reference transforms.py:332-341).

    There it converts torch tensors back with ``.numpy()``; here anything
    array-like goes through ``np.asarray``. As in the JAX package the
    reference's ``ToTensor`` and ``TensorType`` (transforms.py:344-370) are
    not copied: the pipeline stays in numpy, dtype casting is
    ``NumpyType``, and the train loop moves batches to the device.
    """

    def __init__(self, num=-1):
        self.num = num

    def apply(self, img, k, params):
        del params
        if self.num > 0 and k >= self.num:
            return img
        return np.asarray(img)


class Normalize(Base):
    def __init__(self, mean=0.0, std=1.0, num=-1):
        self.mean, self.std, self.num = mean, std, num

    def apply(self, img, k, params):
        del params
        if self.num > 0 and k >= self.num:
            return img
        return (img - self.mean) / self.std


class RandSelect(Base):
    """Apply sub-ops with probability `prob` (transforms.py:158-184)."""

    def __init__(self, prob=0.5, tf=None):
        self.prob = prob
        self.ops = list(tf) if isinstance(tf, (list, tuple)) else [tf]

    def sample(self, rng, shape):
        on = rng.random() < self.prob
        params = []
        if on:
            for op in self.ops:
                shape, p = op.sample(rng, shape)
                params.append(p)
        return list(shape), (on, params)

    def apply(self, img, k, params):
        on, sub = params
        if on:
            for op, p in zip(self.ops, sub):
                img = op.apply(img, k, p)
        return img


class Rot90(Base):
    def __init__(self, axes=(1, 2)):
        self.axes = axes

    def sample(self, rng, shape):
        del rng
        shape = list(shape)
        i, j = self.axes[0] - 1, self.axes[1] - 1
        shape[i], shape[j] = shape[j], shape[i]
        return shape, None

    def apply(self, img, k, params):
        del k, params
        return np.rot90(img, axes=self.axes)


class Flip(Base):
    def __init__(self, axis=0):
        self.axis = axis

    def apply(self, img, k, params):
        del k, params
        return np.flip(img, self.axis)


_NAMESPACE = {
    "Compose": Compose, "Identity": Identity, "Base": Base,
    "RandCrop3D": RandCrop3D, "RandCrop": RandCrop, "CenterCrop": CenterCrop,
    "RandomRotion": RandomRotion, "RandomFlip": RandomFlip,
    "RandomIntensityChange": RandomIntensityChange,
    "NumpyType": NumpyType, "ToNumpy": ToNumpy, "Normalize": Normalize,
    "Pad": Pad,
    "Noise": Noise, "GaussianBlur": GaussianBlur, "RandSelect": RandSelect,
    "Rot90": Rot90, "Flip": Flip,
    "Uniform": Uniform, "Gaussian": Gaussian, "Constant": Constant,
    "np": np,
}


def from_string(spec: str):
    """Build a transform from a reference-style pipeline string.

    Accepts the exact strings the reference CLI injects (options.py:50-51),
    evaluated against a whitelist of transform classes + numpy only.
    """
    if not spec:
        return Identity()
    return eval(spec, {"__builtins__": {}}, _NAMESPACE)  # noqa: S307
