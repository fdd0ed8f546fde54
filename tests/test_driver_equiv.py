"""Retire-cursor driver equivalence: N > front must match lockstep exactly.

Round-3 lesson: the driver branch (N > ``front``) of
``accel/hierarchy.intersect_hierarchy`` was only ever exercised at real
render scales, so a driver rewrite passed the whole CPU suite while
corrupting accelerator renders.  This test forces the driver with a tiny ``front``
and requires bit-identical results against the lockstep (N <= front) path
on the same backend, covering refill, tombstone, retire-append and the
final unique-index scatter, plus the any-hit and masked-lane variants.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from mitsuba_im_tpu.accel import hierarchy as hy


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    n_tri = 6000
    p0 = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1 = (rng.normal(size=(n_tri, 3)) * 0.08).astype(np.float32)
    e2 = (rng.normal(size=(n_tri, 3)) * 0.08).astype(np.float32)
    h = hy.build_hierarchy(p0, e1, e2)

    N = 4096
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return h, jnp.asarray(o), jnp.asarray(d)


def _cmp(a, b):
    for k in ("t", "u", "v", "prim", "inst"):
        fa = np.asarray(a["found"])
        np.testing.assert_array_equal(fa, np.asarray(b["found"]))
        np.testing.assert_array_equal(np.asarray(a[k])[fa],
                                      np.asarray(b[k])[fa], err_msg=k)
    # misses agree on t too (tmax default)
    np.testing.assert_allclose(np.asarray(a["t"]), np.asarray(b["t"]),
                               rtol=1e-6)


@pytest.mark.quick
@pytest.mark.parametrize("front", [
    512,
    pytest.param(1000, marks=pytest.mark.slow),
    pytest.param(4096, marks=pytest.mark.slow),
])
def test_driver_matches_lockstep(setup, front):
    h, o, d = setup
    lock = hy.intersect_hierarchy(h, o, d, 1e-4, 1e30, front=1 << 20)
    drv = hy.intersect_hierarchy(h, o, d, 1e-4, 1e30, front=front)
    _cmp(drv, lock)


@pytest.mark.slow
def test_driver_matches_lockstep_anyhit(setup):
    h, o, d = setup
    lock = hy.intersect_hierarchy(h, o, d, 1e-4, 1e30, front=1 << 20,
                                  any_hit=True)
    drv = hy.intersect_hierarchy(h, o, d, 1e-4, 1e30, front=512,
                                 any_hit=True)
    np.testing.assert_array_equal(np.asarray(drv["found"]),
                                  np.asarray(lock["found"]))


@pytest.mark.quick
def test_driver_matches_lockstep_masked(setup):
    h, o, d = setup
    act = jnp.asarray(np.arange(o.shape[0]) % 3 != 0)
    lock = hy.intersect_hierarchy(h, o, d, 1e-4, 1e30, front=1 << 20,
                                  active=act)
    drv = hy.intersect_hierarchy(h, o, d, 1e-4, 1e30, front=512, active=act)
    _cmp(drv, lock)


@pytest.mark.slow
def test_driver_finite_tmax(setup):
    """tmax must bound t for misses through the driver path too."""
    h, o, d = setup
    drv = hy.intersect_hierarchy(h, o, d, 1e-4, 2.5, front=512)
    lock = hy.intersect_hierarchy(h, o, d, 1e-4, 2.5, front=1 << 20)
    _cmp(drv, lock)
