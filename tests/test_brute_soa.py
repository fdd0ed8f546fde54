"""The component-SoA brute-force intersector (the hot path of small scenes)
against the (N, 3) broadcast reference and the threaded BVH, and the
intersection routing a GPU process traces."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_im_tpu.accel import bvh as bvh_mod
from mitsuba_im_tpu.accel import intersect as isect
from mitsuba_im_tpu.core.v3 import V3
from mitsuba_im_tpu.scene import geometry as geo

from test_intersect import make_geom, random_tri_soup

N_RAYS = 512


def _cornell_geom():
    from __graft_entry__ import _tiny_cornell

    scene, _ = _tiny_cornell()
    return scene.geom


def _soup_geom():
    rng = np.random.default_rng(3)
    return make_geom(*random_tri_soup(400, rng))


def _rays(kind):
    """Random rays: from inside the Cornell box, or through the soup."""
    rng = np.random.default_rng(7)
    if kind == "cornell":
        o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (N_RAYS, 3))
    else:
        o = rng.uniform(-2, 2, (N_RAYS, 3))
    d = rng.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _bvh(g):
    n = g.n_tris
    lo, hi = bvh_mod.tri_bounds(np.asarray(g.tri_p0)[:n],
                                np.asarray(g.tri_e1)[:n],
                                np.asarray(g.tri_e2)[:n])
    return bvh_mod.build_bvh(lo, hi)


SCENES = {"cornell": _cornell_geom, "soup400": _soup_geom}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("reference", ["brute_n3", "bvh"])
def test_closest_hit_matches(scene, reference):
    g = SCENES[scene]()
    o, d = _rays(scene)
    h = isect.intersect_v(g, V3.from_array(o), V3.from_array(d), 1e-4, 1e30)
    tri = np.asarray(h.kind == geo.KIND_TRI)
    if reference == "brute_n3":
        r = isect.intersect_brute(g, o, d, 1e-4, 1e30)
        found = np.asarray(r.kind == geo.KIND_TRI)
        t, prim, u, v = r.t, r.prim, r.u, r.v
    else:
        st = isect.intersect_bvh(_bvh(g), g, o, d, 1e-4,
                                 jnp.full((N_RAYS,), 1e30))
        found = np.asarray(st["found"])
        t, prim, u, v = st["t"], st["prim"], st["u"], st["v"]
    assert found.sum() > N_RAYS // 10  # the rays do hit something
    np.testing.assert_array_equal(tri, found)
    np.testing.assert_array_equal(np.asarray(h.prim)[tri],
                                  np.asarray(prim)[tri])
    np.testing.assert_allclose(np.asarray(h.t)[tri], np.asarray(t)[tri],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(h.u)[tri], np.asarray(u)[tri],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(h.v)[tri], np.asarray(v)[tri],
                               atol=1e-5)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("reference", ["brute_n3", "bvh"])
def test_any_hit_matches(scene, reference):
    g = SCENES[scene]()
    o, d = _rays(scene)
    tmax = 1.5
    occ = isect.occluded_v(g, V3.from_array(o), V3.from_array(d), 1e-4,
                           tmax)
    bvh = _bvh(g) if reference == "bvh" else None
    ref = isect.occluded(g, o, d, 1e-4, tmax, bvh=bvh)
    occ = np.asarray(occ)
    assert 0 < occ.sum() < N_RAYS
    np.testing.assert_array_equal(occ, np.asarray(ref))


def _large_scene():
    from bench_scenes import build_large_scene

    scene, _settings, _n = build_large_scene(8, subdiv=0)
    return scene


@pytest.mark.parametrize("size", ["small", "large"])
@pytest.mark.parametrize("query", ["closest", "any"])
def test_gpu_trace_has_no_pallas_call(monkeypatch, size, query):
    """What a GPU process traces for both scene regimes is plain XLA."""
    from __graft_entry__ import _tiny_cornell

    scene = _tiny_cornell()[0] if size == "small" else _large_scene()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    o = V3.from_array(jnp.zeros((64, 3)))
    d = V3.from_array(jnp.ones((64, 3)))
    if query == "closest":
        fn = lambda o, d: scene.ray_intersect_v(o, d)
    else:
        fn = lambda o, d: scene.occluded_v(o, d, 1e-4, 1.0)
    text = str(jax.make_jaxpr(fn)(o, d))
    assert "pallas_call" not in text
    # large scenes march the hierarchy on accelerators
    assert ("while" in text) == (size == "large")
