"""The B3 kernel's median selection, spelled out on the CPU
(`kernels/stein.lower_median_radix`: 4 passes of 8-bit digits on the bit
patterns), against sorting and against the JAX package's
`stein_pallas.lower_median_bisect`: all three must give the same bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu.kernels import stein_pallas
from svnicp_tpu_torch.kernels import stein as tstein


def _bits(x) -> int:
    return int(np.asarray(x, dtype=np.float32).reshape(1).view(np.int32)[0])


def _check(values: np.ndarray) -> None:
    values = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    want = torch.sort(torch.from_numpy(values)).values[(values.size - 1) // 2]
    got = tstein.lower_median_radix(torch.from_numpy(values))
    jax_med = stein_pallas.lower_median_bisect(jnp.asarray(values))
    assert _bits(got.numpy()) == _bits(want.numpy())
    assert _bits(np.asarray(jax_med)) == _bits(want.numpy())


def _pairwise(x: np.ndarray) -> np.ndarray:
    diff = x[:, None, :] - x[None, :, :]
    return (diff * diff).sum(-1, dtype=np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 100, 1001, 4096])
def test_random_values(rng, n):
    _check(rng.exponential(size=n).astype(np.float32) * 10.0 ** rng.integers(-6, 6, n))


@pytest.mark.parametrize("value", [0.0, 1.0, 3.5e-12, 7.0e30])
def test_all_equal(value):
    _check(np.full(257, value, np.float32))


def test_heavy_duplicates(rng):
    _check(rng.choice(np.array([0.0, 0.25, 0.25, 1.0, 9.0], np.float32), size=5000))


def test_last_mantissa_bit(rng):
    base = np.float32(1.2345678)
    ulps = np.arange(-40, 41).astype(np.int32) + base.view(np.int32)
    _check(rng.permutation(np.concatenate([ulps, ulps[::3]]).view(np.float32)))


@pytest.mark.parametrize("p", [2, 10, 64, 512])
def test_pairwise_distances(rng, p):
    """n = P^2 squared distances with the zero diagonal, as the kernel sees
    them; half the particles are copies of the other half."""
    x = rng.normal(size=(p, 6)).astype(np.float32)
    x[p // 2:] = x[: p - p // 2]
    _check(_pairwise(x))
