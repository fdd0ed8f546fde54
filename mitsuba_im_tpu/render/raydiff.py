"""Ray differentials: pixel footprints for MIP/anisotropic texture filtering.

The reference propagates a ``PixelDifferential``
(``/root/reference/include/mitsuba/render/integrator2.h:136``) through the
sensor and transfers it at the first intersection to drive the MIP/EWA
texture filter (``mipmap.h``).  Redesign: differentials are computed in
closed form on the wavefront — no per-ray state is carried through bounces:

- :func:`camera_ray_differentials` re-evaluates the sensor mapping at
  one-pixel offsets (exact for all sensor types, zero extra state);
- :func:`uv_differentials` transfers the footprint at a triangle hit by
  intersecting the offset rays with the hit triangle's plane and solving
  the 2x2 barycentric system — exact for triangles, no finite-difference
  epsilon.

Secondary bounces fall back to unfiltered lookups (the reference's
interactive path behaves the same).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Float
from ..scene.geometry import KIND_TRI


def camera_ray_differentials(sensor, uv_u, uv_v, u_lens_a, u_lens_b,
                             inv_w: float, inv_h: float):
    """Direction deltas of the primary ray for +1-pixel film offsets.

    Returns (dddx, dddy): V3 direction differences (origin differentials
    vanish for pinhole sensors; for thinlens/ortho the origin shift is
    folded into the direction delta at the focus plane, the standard
    approximation)."""
    from ..sensor.table import sample_ray_v

    _o0, d0, _ = sample_ray_v(sensor, uv_u, uv_v, u_lens_a, u_lens_b)
    _ox, dx_, _ = sample_ray_v(sensor, uv_u + inv_w, uv_v, u_lens_a, u_lens_b)
    _oy, dy_, _ = sample_ray_v(sensor, uv_u, uv_v + inv_h, u_lens_a, u_lens_b)
    return dx_ - d0, dy_ - d0


def uv_differentials(geom, hit, o, d, dddx, dddy):
    """Screen-space UV derivatives at the primary hit (triangles only).

    o, d, dddx, dddy: V3 wavefronts; returns (dudx, dvdx, dudy, dvdy) flat
    (N,) arrays (zero on non-triangle / miss lanes).
    """
    from ..core import v3 as v
    from ..scene.geometry import _gather3_v, _gather2_v

    is_tri = hit.kind == KIND_TRI
    tp = jnp.where(is_tri, hit.prim, 0)
    p0 = _gather3_v(geom.tri_p0, tp)
    if geom.tri_shad is not None and geom.tri_shad.shape[0] > v.SELECT_MAX:
        # one packed shading-row gather (see Geometry.tri_shad)
        row = geom.tri_shad[tp]
        e1 = v.V3(row[:, 0], row[:, 1], row[:, 2])
        e2 = v.V3(row[:, 3], row[:, 4], row[:, 5])
        uv0u, uv0v = row[:, 15], row[:, 16]
        uv1u, uv1v = row[:, 17], row[:, 18]
        uv2u, uv2v = row[:, 19], row[:, 20]
    else:
        e1 = _gather3_v(geom.tri_e1, tp)
        e2 = _gather3_v(geom.tri_e2, tp)
        uv0u, uv0v = _gather2_v(geom.tri_uv0, tp)
        uv1u, uv1v = _gather2_v(geom.tri_uv1, tp)
        uv2u, uv2v = _gather2_v(geom.tri_uv2, tp)
    n = e1.cross(e2)

    # 2x2 Gram system for barycentrics of a point on the triangle plane
    g11 = e1.dot(e1)
    g12 = e1.dot(e2)
    g22 = e2.dot(e2)
    det = g11 * g22 - g12 * g12
    inv_det = jnp.where(jnp.abs(det) > 1e-20, 1.0 / det, 0.0)

    num = (p0 - o).dot(n)

    def transfer(doff):
        dk = d + doff
        denom = dk.dot(n)
        tk = num / jnp.where(jnp.abs(denom) > 1e-20, denom, 1.0)
        pk = o + dk * tk
        r = pk - p0
        r1 = r.dot(e1)
        r2 = r.dot(e2)
        b1 = (g22 * r1 - g12 * r2) * inv_det
        b2 = (g11 * r2 - g12 * r1) * inv_det
        uk = uv0u * (1.0 - b1 - b2) + uv1u * b1 + uv2u * b2
        vk = uv0v * (1.0 - b1 - b2) + uv1v * b1 + uv2v * b2
        return uk, vk

    # uv at the actual hit from its barycentrics (hit.u, hit.v)
    w0 = 1.0 - hit.u - hit.v
    u_hit = uv0u * w0 + uv1u * hit.u + uv2u * hit.v
    v_hit = uv0v * w0 + uv1v * hit.u + uv2v * hit.v

    ux, vx = transfer(dddx)
    uy, vy = transfer(dddy)
    z = jnp.zeros_like(u_hit)
    ok = is_tri & hit.valid if hasattr(hit, "valid") else is_tri
    pick = lambda a: jnp.where(ok, a, 0.0)
    return (pick(ux - u_hit), pick(vx - v_hit),
            pick(uy - u_hit), pick(vy - v_hit))
