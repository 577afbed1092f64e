"""Port permutohedral math vs the JAX package: keys equal, barycentrics to 1e-6.

The same seeded numpy points go through both; keys must match exactly (a
flipped simplex would change the lattice), barycentric weights to 1e-6
absolute (f32 values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lattice_net_tpu.lattice import permutohedral as jp
from lattice_net_tpu_torch.lattice import permutohedral as tp

torch.set_num_threads(2)

BARY_ATOL = 1e-6


def test_elevation_matrix_matches():
    for d in (2, 3):
        np.testing.assert_array_equal(
            np.asarray(jp.elevation_matrix(d)), tp.elevation_matrix(d).numpy()
        )


@pytest.mark.parametrize("scale", [0.5, 30.0, 400.0])
def test_splat_coords_match(scale):
    rng = np.random.default_rng(int(scale * 10))
    p = (rng.normal(size=(20000, 3)) * scale).astype(np.float32)
    kj, bj = jax.jit(jp.splat_coords)(jnp.asarray(p))
    kt, bt = tp.splat_coords(torch.from_numpy(p))
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    np.testing.assert_allclose(np.asarray(bj), bt.numpy(), rtol=0, atol=BARY_ATOL)
    # every point's weights sum to 1
    np.testing.assert_allclose(bt.sum(-1).numpy(), 1.0, atol=1e-5)


def test_enclosing_simplex_parts_match():
    rng = np.random.default_rng(7)
    e = jp.elevate(jnp.asarray((rng.normal(size=(5000, 3)) * 5).astype(np.float32)))
    rj, kj, bj = jp.find_enclosing_simplex(e)
    rt, kt, bt = tp.find_enclosing_simplex(torch.from_numpy(np.array(e)))
    np.testing.assert_array_equal(np.asarray(rj), rt.numpy())
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    np.testing.assert_allclose(np.asarray(bj), bt.numpy(), rtol=0, atol=BARY_ATOL)


def test_splat_coords_elevated_on_half_integer_points():
    # the coarse-level input: integer lattice keys halved (exact in f32),
    # where many points sit on simplex boundaries
    rng = np.random.default_rng(3)
    k = rng.integers(-40, 40, size=(4000, 3)).astype(np.int32)
    elev = np.concatenate([k, -k.sum(-1, keepdims=True)], -1).astype(np.float32) / 2.0
    kj, bj = jp.splat_coords_elevated(jnp.asarray(elev))
    kt, bt = tp.splat_coords_elevated(torch.from_numpy(elev))
    np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
    np.testing.assert_allclose(np.asarray(bj), bt.numpy(), rtol=0, atol=BARY_ATOL)
