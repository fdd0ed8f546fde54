"""Cluster-marching intersector: cross-validation against brute force on
random soups and the reference bunny."""
import numpy as np
import jax.numpy as jnp
import pytest

from mitsuba_im_tpu.accel import cluster as cl
from mitsuba_im_tpu.accel import intersect as isect
from mitsuba_im_tpu.scene import geometry as geo

from test_intersect import random_tri_soup, make_geom


class TestClusterMarch:
    @pytest.mark.parametrize("n_tris", [70, 700])
    def test_matches_brute_force(self, rng, n_tris):
        p0, e1, e2 = random_tri_soup(n_tris, rng)
        g = make_geom(p0, e1, e2)
        cs = cl.build_clusters(p0, e1, e2)
        assert cs.n_clusters >= 1

        n_rays = 512
        o = jnp.asarray(rng.uniform(-2, 2, (n_rays, 3)), jnp.float32)
        d = jnp.asarray(rng.normal(size=(n_rays, 3)), jnp.float32)
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)

        hb = isect.intersect_brute(g, o, d, 1e-4, 1e30)
        st = cl.intersect_clusters(cs, o, d, 1e-4, 1e30)

        hitb = np.asarray(hb.kind == geo.KIND_TRI)
        np.testing.assert_array_equal(hitb, np.asarray(st["found"]))
        m = hitb
        np.testing.assert_allclose(
            np.asarray(st["t"])[m], np.asarray(hb.t)[m], rtol=1e-4
        )
        np.testing.assert_array_equal(
            np.asarray(st["prim"])[m], np.asarray(hb.prim)[m]
        )

    def test_anyhit(self, rng):
        p0, e1, e2 = random_tri_soup(300, rng)
        g = make_geom(p0, e1, e2)
        cs = cl.build_clusters(p0, e1, e2)
        n_rays = 256
        o = jnp.asarray(rng.uniform(-2, 2, (n_rays, 3)), jnp.float32)
        d = jnp.asarray(rng.normal(size=(n_rays, 3)), jnp.float32)
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
        occ_b = isect.occluded(g, o, d, 1e-4, 10.0)
        st = cl.intersect_clusters(cs, o, d, 1e-4, 10.0, any_hit=True)
        np.testing.assert_array_equal(np.asarray(occ_b), np.asarray(st["found"]))

    def test_bunny(self, rng):
        import os

        path = "/root/reference/data/tests/bunny.ply"
        if not os.path.exists(path):
            pytest.skip("no bunny")
        from mitsuba_im_tpu.scene.mesh import load_ply

        mesh = load_ply(path)
        p = mesh.positions
        i = mesh.indices
        p0 = p[i[:, 0]].astype(np.float32)
        e1 = (p[i[:, 1]] - p[i[:, 0]]).astype(np.float32)
        e2 = (p[i[:, 2]] - p[i[:, 0]]).astype(np.float32)
        cs = cl.build_clusters(p0, e1, e2)
        g = make_geom(p0, e1, e2)

        n_rays = 128
        c = p.mean(0)
        o = jnp.asarray(c + rng.uniform(-0.2, 0.2, (n_rays, 3)), jnp.float32)
        d = jnp.asarray(rng.normal(size=(n_rays, 3)), jnp.float32)
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)

        from mitsuba_im_tpu.accel import bvh as bvh_mod

        lo, hi = bvh_mod.tri_bounds(p0, e1, e2)
        bvh = bvh_mod.build_bvh(lo, hi)
        st_bvh = isect.intersect_bvh(bvh, g, o, d, 1e-5, jnp.full((n_rays,), 1e30))
        st_cl = cl.intersect_clusters(cs, o, d, 1e-5, 1e30)
        np.testing.assert_array_equal(
            np.asarray(st_bvh["found"]), np.asarray(st_cl["found"])
        )
        m = np.asarray(st_bvh["found"])
        np.testing.assert_allclose(
            np.asarray(st_cl["t"])[m], np.asarray(st_bvh["t"])[m], rtol=1e-4
        )
