"""Every float32 matrix product on the device path asks for full precision:
a GPU would otherwise run it in TF32 (about three decimal digits)."""
import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for p in eqn.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for sub in subs:
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _hierarchy_instanced():
    from mitsuba_im_tpu.accel import hierarchy as hy
    from test_intersect import random_tri_soup

    p0, e1, e2 = random_tri_soup(300, np.random.default_rng(0))
    shift = np.concatenate([np.eye(3), [[2.0], [0.0], [0.0]]], 1)
    h = hy.build_hierarchy_instanced(
        [(p0, e1, e2, None)], [(0, np.eye(3, 4)), (0, shift)])
    o = jnp.zeros((16, 3))
    d = jnp.ones((16, 3))
    return lambda: hy.intersect_hierarchy(h, o, d, 1e-4, 1e30)


def _instance_normals():
    from mitsuba_im_tpu.scene import geometry as geo
    from test_intersect import make_geom, random_tri_soup

    p0, e1, e2 = random_tri_soup(4, np.random.default_rng(1))
    g = make_geom(p0, e1, e2).replace(
        inst_rot=jnp.broadcast_to(jnp.eye(3), (2, 3, 3)), instanced=True)
    hit = geo.Hit(t=jnp.ones(8), kind=jnp.full(8, geo.KIND_TRI),
                  prim=jnp.zeros(8, jnp.int32), shape=jnp.zeros(8, jnp.int32),
                  u=jnp.zeros(8), v=jnp.zeros(8), inst=jnp.ones(8, jnp.int32))
    o = jnp.zeros((8, 3))
    return lambda: geo.compute_interaction(g, o, o + 1.0, hit)


def _grid_lookup():
    from mitsuba_im_tpu.media.medium import _trilinear

    return lambda: _trilinear(jnp.ones(27), jnp.zeros(4, jnp.int32),
                              jnp.full((4, 3), 3, jnp.int32),
                              jnp.ones((4, 12)), jnp.ones((4, 3)))


def _camera_pdf():
    from __graft_entry__ import _tiny_cornell
    from mitsuba_im_tpu.integrators.bdpt import camera_pdf_dir

    scene, _ = _tiny_cornell()
    return lambda: camera_pdf_dir(scene, jnp.ones((8, 3)))


def _irrcache(grid):
    from mitsuba_im_tpu.integrators import irrcache as ic

    N, M = 8, 64
    p = jnp.zeros((N, 3))
    rec = (jnp.zeros((M, 3)), jnp.ones((M, 3)), jnp.ones((M, 3)),
           jnp.ones(M), jnp.ones(M, bool))
    g = None
    if grid:
        g = (jnp.arange(ic.K_DENSE, dtype=jnp.int32) % M,
             jnp.arange(M, dtype=jnp.int32), jnp.arange(M, dtype=jnp.int32),
             jnp.float32(0.5))
    return lambda: ic._gather_cache(p, p + 1.0, *rec, 1.0, grid=g)


def _spectrum():
    from mitsuba_im_tpu.core.spectrum import rgb_to_xyz, xyz_to_rgb

    return lambda: xyz_to_rgb(rgb_to_xyz(jnp.ones((8, 3))))


def _envmap():
    from mitsuba_im_tpu.emitter import table as et
    from __graft_entry__ import _tiny_cornell

    em = _tiny_cornell()[0].emitters
    return lambda: et._env_dir_from_uv(
        em, et._env_uv_from_dir(em, jnp.ones((8, 3))))


SITES = {
    "hierarchy_instance_transform": _hierarchy_instanced,
    "instance_normal_rotation": _instance_normals,
    "medium_grid_lookup": _grid_lookup,
    "bdpt_camera_projection": _camera_pdf,
    "irrcache_dense": lambda: _irrcache(False),
    "irrcache_grid": lambda: _irrcache(True),
    "spectrum_rgb_xyz": _spectrum,
    "envmap_dir_uv": _envmap,
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_matmuls_ask_for_highest_precision(site):
    precisions = _dot_precisions(jax.make_jaxpr(SITES[site]())().jaxpr)
    assert precisions, "no matrix product traced"
    for p in precisions:
        assert p in ((HIGHEST, HIGHEST), HIGHEST), p
