"""raypt_torch's threefry sampling is bit for bit the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.rng import sampler as jrng
from raypt_torch.rng import sampler as trng

torch.set_num_threads(2)


def _key_bits(k) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1])
def test_key_and_fold_in_bitwise(seed):
    jk = jax.random.key(seed)
    tk = trng.key(seed)
    assert _key_bits(jk) == tuple(tk)
    for data in (0, 1, 3, 0xA11CE, 2 ** 31 - 1, 2 ** 32 - 1):
        assert _key_bits(jax.random.fold_in(jk, data)) == tuple(
            trng.fold_in(tk, data))
    assert _key_bits(jrng.sample_key(jrng.frame_key(jk, 7), 2)) == tuple(
        trng.sample_key(trng.frame_key(tk, 7), 2))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_per_pixel_uniforms_bitwise(n):
    rng = np.random.default_rng(n)
    ids = rng.integers(0, 1 << 22, size=(37, 29)).astype(np.int32)
    k = jax.random.fold_in(jax.random.key(5), 11)
    ref = np.asarray(jrng._per_pixel_uniforms(k, jnp.asarray(ids), n))
    got = trng._per_pixel_uniforms(trng.fold_in(trng.key(5), 11),
                                   torch.from_numpy(ids), n).numpy()
    assert got.shape == ref.shape
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_jitter_and_bounce_uniforms_bitwise():
    ids = torch.arange(1024, dtype=torch.int32).reshape(32, 32)
    jk = jrng.sample_key(jrng.frame_key(jax.random.key(0), 0), 0)
    tk = trng.sample_key(trng.frame_key(trng.key(0), 0), 0)
    jids = jnp.asarray(ids.numpy())
    assert np.array_equal(trng.sample_jitter(tk, ids).numpy(),
                          np.asarray(jrng.sample_jitter(jk, jids)))
    for b in range(3):
        assert np.array_equal(trng.bounce_uniforms(tk, b, ids).numpy(),
                              np.asarray(jrng.bounce_uniforms(jk, b, jids)))


def test_random_point_on_sphere_close():
    """cos/sin differ between torch's and XLA's CPU kernels in the last
    bits; tolerance 4e-7 absolute on unit vectors (measured worst case
    6.0e-8)."""
    rng = np.random.default_rng(2)
    u = rng.random((2, 4096)).astype(np.float32)
    ref = np.asarray(jrng.random_point_on_sphere(jnp.asarray(u[0]),
                                                 jnp.asarray(u[1])))
    got = trng.random_point_on_sphere(torch.from_numpy(u[0]),
                                      torch.from_numpy(u[1])).numpy()
    assert np.abs(got - ref).max() <= 4e-7
