"""Random-value samplers for transform parameters (copy of
`passion_tpu/data/rand.py`; reference code/data/rand.py).

Unlike the reference (module-global `random`), every sampler draws from an
explicit `numpy.random.Generator`, making the host augmentation pipeline
thread-safe and reproducible per (seed, epoch, index).
"""

from __future__ import annotations


class Constant:
    def __init__(self, value):
        self.value = value

    def sample(self, rng):
        del rng
        return self.value


class Uniform:
    def __init__(self, a=0.0, b=1.0):
        self.a, self.b = a, b

    def sample(self, rng):
        return rng.uniform(self.a, self.b)


class Gaussian:
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def sample(self, rng):
        return rng.normal(self.mean, self.std)
