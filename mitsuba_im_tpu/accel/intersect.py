"""Ray-scene intersection (closest-hit and any-hit).

Replaces the reference's kd-tree traversal stack
(``/root/reference/include/mitsuba/render/skdtree.h:431`` Havran traversal,
``triaccel.h:37`` Wald projection test) with three strategies, picked by
the scene's size and the accelerator it carries:

1. **Brute-force broadcast** -- every ray tests every primitive as dense
   ``(rays, prims)`` Moeller-Trumbore planes that XLA fuses with their
   min-reduction.  Used up to ``BRUTE_FORCE_MAX`` triangles (Cornell-box
   class scenes).
2. **Two-level hierarchy** (:mod:`mitsuba_im_tpu.accel.hierarchy`) -- the
   large-scene path on accelerators, and for instanced scenes everywhere.
3. **Threaded-BVH walk** -- stackless skip-link traversal
   (:mod:`mitsuba_im_tpu.accel.bvh`) as a vectorized ``lax.while_loop``;
   large scenes take it on the CPU backend.

All return identical :class:`Hit` records; analytic spheres/disks are always
tested brute-force (their counts are tiny).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Float, Int, INVALID
from ..core import math as m
from ..scene.geometry import (
    Geometry,
    Hit,
    KIND_NONE,
    KIND_TRI,
    KIND_SPHERE,
    KIND_DISK,
)
from .bvh import FlatBVH

BRUTE_FORCE_MAX = 512  # tris; above this the hierarchy or BVH is used
BIG = 3.0e37
IBIG = 2 ** 31 - 1


def _brute(geom: Geometry, bvh, clusters) -> bool:
    """Small (or accelerator-less) soups are tested brute-force; instanced
    hierarchies never are: their flat tables hold BLAS-local geometry."""
    return not _indirect(clusters) and (
        (bvh is None and clusters is None) or geom.n_tris <= BRUTE_FORCE_MAX)


def _use_hierarchy(bvh, clusters) -> bool:
    """Large scenes march the hierarchy unless a BVH was asked for and the
    computation is placed on the CPU backend (where the threaded walk is
    the tested reference).  Respects ``jax.default_device(cpu)`` so the
    device-vs-CPU parity check can trace the CPU variant from a GPU
    process."""
    if clusters is None:
        return False
    if _indirect(clusters) or bvh is None:
        return True
    dev = jax.config.jax_default_device
    platform = (getattr(dev, "platform", None) if dev is not None
                else jax.default_backend())
    return platform != "cpu"


# ---------------------------------------------------------------------------
# Primitive tests (broadcast over a trailing primitive axis)
# ---------------------------------------------------------------------------

def _moeller_trumbore(o, d, p0, e1, e2, tmin, tmax):
    """Batched MT test. o,d: (R, 1, 3); p0,e1,e2: (1|R, P, 3) -> (R, P) each.
    Returns (hit_mask, t, u, v)."""
    pvec = m.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = o - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = m.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    return hit, t, u, v


def _sphere_test(o, d, center, radius, tmin, tmax):
    """Quadric sphere test; returns nearest valid root per (R, S)."""
    L = o - center
    b = 2.0 * jnp.sum(d * L, axis=-1)
    c = jnp.sum(L * L, axis=-1) - radius * radius
    a = jnp.sum(d * d, axis=-1)
    disc = b * b - 4 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    # numerically stable roots
    sb = jnp.where(b >= 0.0, 1.0, -1.0)  # sign(0) must be 1, not 0
    q = -0.5 * (b + sb * sq)
    t0 = q / jnp.where(a == 0, 1.0, a)
    t1 = c / jnp.where(q == 0, 1.0, q)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    t = jnp.where((lo > tmin) & (lo < tmax), lo, hi)
    hit = ok & (t > tmin) & (t < tmax) & (radius > 0)
    return hit, t


def _disk_test(o, d, center, n, s, t_axis, radius, tmin, tmax):
    denom = jnp.sum(d * n, axis=-1)
    tt = jnp.sum((center - o) * n, axis=-1) / jnp.where(denom == 0, 1.0, denom)
    p = o + d * tt[..., None]
    local = p - center
    r2 = jnp.sum(local * local, axis=-1) - jnp.sum(local * n, axis=-1) ** 2
    hit = (
        (jnp.abs(denom) > 1e-12)
        & (tt > tmin)
        & (tt < tmax)
        & (r2 <= radius * radius)
        & (radius > 0)
    )
    return hit, tt


# ---------------------------------------------------------------------------
# Brute-force closest hit
# ---------------------------------------------------------------------------

def _closest_from_masked(t, mask, axis=-1):
    tm = jnp.where(mask, t, BIG)
    idx = jnp.argmin(tm, axis=axis)
    tbest = jnp.min(tm, axis=axis)  # reduce, not take_along_axis (slow gather)
    return idx.astype(Int), tbest, tbest < BIG


def intersect_brute(geom: Geometry, o, d, tmin, tmax) -> Hit:
    """All-primitives test; o, d: (R, 3); tmin/tmax: scalar or (R,)."""
    R = o.shape[0]
    o_b = o[:, None, :]
    d_b = d[:, None, :]
    tmin_b = jnp.broadcast_to(jnp.asarray(tmin, Float), (R,))[:, None]
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, Float), (R,))[:, None]

    th, tt, tu, tv = _moeller_trumbore(
        o_b, d_b, geom.tri_p0[None], geom.tri_e1[None], geom.tri_e2[None],
        tmin_b, tmax_b,
    )
    ti, tbest, tvalid = _closest_from_masked(tt, th)
    tri_pack = (ti, tbest, tvalid, tu, tv)

    sh, st = _sphere_test(
        o_b, d_b, geom.sph_center[None], geom.sph_radius[None], tmin_b, tmax_b
    )
    si, sbest, svalid = _closest_from_masked(st, sh)

    dh, dt = _disk_test(
        o_b, d_b, geom.disk_center[None], geom.disk_n[None], geom.disk_s[None],
        geom.disk_t[None], geom.disk_radius[None], tmin_b, tmax_b,
    )
    di, dbest, dvalid = _closest_from_masked(dt, dh)

    return _merge_hits(geom, tri_pack, (si, sbest, svalid), (di, dbest, dvalid))


def _merge_hits(geom, tri, sph, disk):
    ti, tbest, tvalid, tu_all, tv_all = tri
    si, sbest, svalid = sph
    di, dbest, dvalid = disk

    tbest = jnp.where(tvalid, tbest, BIG)
    sbest = jnp.where(svalid, sbest, BIG)
    dbest = jnp.where(dvalid, dbest, BIG)

    best = jnp.minimum(jnp.minimum(tbest, sbest), dbest)
    kind = jnp.where(
        best >= BIG,
        KIND_NONE,
        jnp.where(tbest == best, KIND_TRI, jnp.where(sbest == best, KIND_SPHERE, KIND_DISK)),
    ).astype(Int)
    prim = jnp.where(kind == KIND_TRI, ti, jnp.where(kind == KIND_SPHERE, si, di))
    u = jnp.take_along_axis(tu_all, ti[..., None], axis=-1)[..., 0]
    v = jnp.take_along_axis(tv_all, ti[..., None], axis=-1)[..., 0]
    u = jnp.where(kind == KIND_TRI, u, 0.0)
    v = jnp.where(kind == KIND_TRI, v, 0.0)
    from ..core.gather import gather_rows

    shape = jnp.where(
        kind == KIND_TRI,
        gather_rows(geom.tri_shape, jnp.clip(prim, 0, geom.tri_shape.shape[0] - 1)),
        jnp.where(
            kind == KIND_SPHERE,
            gather_rows(geom.sph_shape, jnp.clip(prim, 0, geom.sph_shape.shape[0] - 1)),
            gather_rows(geom.disk_shape, jnp.clip(prim, 0, geom.disk_shape.shape[0] - 1)),
        ),
    )
    shape = jnp.where(kind == KIND_NONE, INVALID, shape)
    return Hit(
        t=jnp.where(kind == KIND_NONE, BIG, best),
        kind=kind,
        prim=jnp.where(kind == KIND_NONE, 0, prim).astype(Int),
        shape=shape.astype(Int),
        u=u,
        v=v,
    )


# ---------------------------------------------------------------------------
# Threaded-BVH closest hit
# ---------------------------------------------------------------------------

def _slab_test(o, inv_d, lo, hi, tmin, tmax):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    t_near = jnp.maximum(jnp.max(tn, axis=-1), tmin)
    t_far = jnp.minimum(jnp.min(tf, axis=-1), tmax)
    return t_near <= t_far


def intersect_bvh(bvh: FlatBVH, geom: Geometry, o, d, tmin, tmax, any_hit=False):
    """Stackless skip-link traversal, vectorized over a flat ray batch."""
    R = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, Float), (R,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, Float), (R,))
    d_safe = jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    inv_d = 1.0 / d_safe
    LEAF = bvh.leaf_size

    init = dict(
        node=jnp.zeros((R,), Int),
        t=tmax,
        prim=jnp.zeros((R,), Int),
        u=jnp.zeros((R,), Float),
        v=jnp.zeros((R,), Float),
        found=jnp.zeros((R,), bool),
    )

    def cond(st):
        return jnp.any(st["node"] >= 0)

    def body(st):
        node = jnp.maximum(st["node"], 0)
        active = st["node"] >= 0
        lo = bvh.node_lo[node]
        hi = bvh.node_hi[node]
        count = bvh.node_count[node]
        start = bvh.node_start[node]
        skip = bvh.node_skip[node]

        if any_hit:
            limit = jnp.where(st["found"], -jnp.inf, st["t"])
        else:
            limit = st["t"]
        box_hit = _slab_test(o, inv_d, lo, hi, tmin, limit) & active
        is_leaf = count > 0

        t_cur, u_cur, v_cur, p_cur, f_cur = st["t"], st["u"], st["v"], st["prim"], st["found"]
        do_prims = box_hit & is_leaf
        for k in range(LEAF):
            pid = bvh.order[jnp.clip(start + k, 0, bvh.order.shape[0] - 1)]
            valid = do_prims & (k < count)
            h, t, u, v = _moeller_trumbore(
                o, d, geom.tri_p0[pid], geom.tri_e1[pid], geom.tri_e2[pid],
                tmin, t_cur,
            )
            h = h & valid
            t_cur = jnp.where(h, t, t_cur)
            u_cur = jnp.where(h, u, u_cur)
            v_cur = jnp.where(h, v, v_cur)
            p_cur = jnp.where(h, pid, p_cur)
            f_cur = f_cur | h

        # descend into near child on inner-node hit, else follow skip
        next_node = jnp.where(box_hit & ~is_leaf, node + 1, skip)
        next_node = jnp.where(active, next_node, -1)
        if any_hit:
            next_node = jnp.where(f_cur, -1, next_node)
        return dict(node=next_node, t=t_cur, prim=p_cur, u=u_cur, v=v_cur, found=f_cur)

    st = jax.lax.while_loop(cond, body, init)
    return st  # raw dict; callers merge with analytic prims


def _dispatch_clusters(clusters, o, d, tmin, tmax, any_hit=False,
                       active=None, coherent=False):
    """Route to the two-level hierarchy or the legacy single-level marcher."""
    from .hierarchy import Hierarchy, intersect_hierarchy, PROLOGUE

    if isinstance(clusters, Hierarchy):
        # the full-width prologue is meant for coherent camera bundles;
        # callers flag them
        return intersect_hierarchy(clusters, o, d, tmin, tmax,
                                   any_hit=any_hit, active=active,
                                   prologue=PROLOGUE if coherent else 0)
    from .cluster import intersect_clusters

    return intersect_clusters(clusters, o, d, tmin, tmax, any_hit=any_hit)


def _indirect(clusters) -> bool:
    """Instanced hierarchies must route through the hierarchy on every
    backend: the flat tables hold BLAS-local geometry."""
    return clusters is not None and getattr(clusters, "indirect", False)


def intersect(geom: Geometry, o, d, tmin, tmax, bvh: FlatBVH | None = None,
              clusters=None, active=None, coherent=False) -> Hit:
    """Closest-hit entry point: brute force for small soups; on big scenes
    the hierarchy or the threaded BVH (see ``_use_hierarchy``); analytic
    prims always tested."""
    with jax.named_scope("closest_hit"):
        if _brute(geom, bvh, clusters):
            return intersect_brute(geom, o, d, tmin, tmax)
        if _use_hierarchy(bvh, clusters):
            sg = jax.lax.stop_gradient
            st = _dispatch_clusters(clusters, sg(o), sg(d), sg(tmin),
                                    sg(tmax), active=active,
                                    coherent=coherent)
        else:
            st = intersect_bvh(bvh, geom, o, d, tmin, tmax)
    R = o.shape[0]
    ti, tbest, tvalid = st["prim"], st["t"], st["found"]
    # recompute u,v from stored
    o_b = o[:, None, :]
    d_b = d[:, None, :]
    tmin_b = jnp.broadcast_to(jnp.asarray(tmin, Float), (R,))[:, None]
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, Float), (R,))[:, None]
    sh, stt = _sphere_test(
        o_b, d_b, geom.sph_center[None], geom.sph_radius[None], tmin_b, tmax_b
    )
    si, sbest, svalid = _closest_from_masked(stt, sh)
    dh, dt = _disk_test(
        o_b, d_b, geom.disk_center[None], geom.disk_n[None], geom.disk_s[None],
        geom.disk_t[None], geom.disk_radius[None], tmin_b, tmax_b,
    )
    di, dbest, dvalid = _closest_from_masked(dt, dh)

    tbest_m = jnp.where(tvalid, tbest, BIG)
    sbest_m = jnp.where(svalid, sbest, BIG)
    dbest_m = jnp.where(dvalid, dbest, BIG)
    best = jnp.minimum(jnp.minimum(tbest_m, sbest_m), dbest_m)
    kind = jnp.where(
        best >= BIG,
        KIND_NONE,
        jnp.where(tbest_m == best, KIND_TRI, jnp.where(sbest_m == best, KIND_SPHERE, KIND_DISK)),
    ).astype(Int)
    prim = jnp.where(kind == KIND_TRI, ti, jnp.where(kind == KIND_SPHERE, si, di)).astype(Int)
    shape = jnp.where(
        kind == KIND_TRI, geom.tri_shape[prim],
        jnp.where(kind == KIND_SPHERE, geom.sph_shape[prim], geom.disk_shape[prim]),
    )
    return Hit(
        t=jnp.where(kind == KIND_NONE, BIG, best),
        kind=kind,
        prim=jnp.where(kind == KIND_NONE, 0, prim),
        shape=jnp.where(kind == KIND_NONE, INVALID, shape).astype(Int),
        u=jnp.where(kind == KIND_TRI, st["u"], 0.0),
        v=jnp.where(kind == KIND_TRI, st["v"], 0.0),
        inst=jnp.where(kind == KIND_TRI, st.get("inst", 0), 0).astype(Int),
    )


# ---------------------------------------------------------------------------
# Component-SoA entry points (canonical for the wavefront hot path)
# ---------------------------------------------------------------------------

def _sphere_best_v(geom, o, d, tmin, tmax):
    """Loop over the (tiny) sphere table at full lane density."""
    from ..core import v3 as v

    R = o.x.shape[0]
    best_t = jnp.full((R,), BIG, Float)
    best_i = jnp.zeros((R,), Int)
    a = d.dot(d)
    for k in range(geom.sph_center.shape[0]):
        c = v.V3(geom.sph_center[k, 0], geom.sph_center[k, 1],
                 geom.sph_center[k, 2])
        radius = geom.sph_radius[k]
        L = o - c
        b = 2.0 * d.dot(L)
        cc = L.dot(L) - radius * radius
        disc = b * b - 4 * a * cc
        ok = disc >= 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        sb = jnp.where(b >= 0.0, 1.0, -1.0)
        q = -0.5 * (b + sb * sq)
        t0 = q / jnp.where(a == 0, 1.0, a)
        t1 = cc / jnp.where(q == 0, 1.0, q)
        lo = jnp.minimum(t0, t1)
        hi = jnp.maximum(t0, t1)
        t = jnp.where((lo > tmin) & (lo < tmax), lo, hi)
        hit = ok & (t > tmin) & (t < tmax) & (radius > 0) & (t < best_t)
        best_t = jnp.where(hit, t, best_t)
        best_i = jnp.where(hit, k, best_i)
    return best_i, best_t, best_t < BIG


def _disk_best_v(geom, o, d, tmin, tmax):
    from ..core import v3 as v

    R = o.x.shape[0]
    best_t = jnp.full((R,), BIG, Float)
    best_i = jnp.zeros((R,), Int)
    for k in range(geom.disk_center.shape[0]):
        c = v.V3(geom.disk_center[k, 0], geom.disk_center[k, 1],
                 geom.disk_center[k, 2])
        n = v.V3(geom.disk_n[k, 0], geom.disk_n[k, 1], geom.disk_n[k, 2])
        radius = geom.disk_radius[k]
        denom = d.dot(n)
        tt = (c - o).dot(n) / jnp.where(denom == 0, 1.0, denom)
        p = o + d * tt
        local = p - c
        r2 = local.dot(local) - local.dot(n) ** 2
        hit = ((jnp.abs(denom) > 1e-12) & (tt > tmin) & (tt < tmax)
               & (r2 <= radius * radius) & (radius > 0) & (tt < best_t))
        best_t = jnp.where(hit, tt, best_t)
        best_i = jnp.where(hit, k, best_i)
    return best_i, best_t, best_t < BIG


def mt_planes(o, d, p0, e1, e2):
    """Componentwise Moeller-Trumbore on broadcasting 2-D planes.

    o, d, p0, e1, e2: 3-tuples of components, rays as ``(N, 1)`` columns and
    triangles as ``(1, P)`` rows or ``(N, P)`` planes.  Returns (inside, t,
    u, v): ``inside`` tests the determinant and barycentrics, the caller
    adds its own t range.  2-D planes of scalar math (not ``(N, P, 3)``
    intermediates) fuse with the reduction that consumes them."""
    ox, oy, oz = o
    dx, dy, dz = d
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvx = ox - p0[0]
    tvy = oy - p0[1]
    tvz = oz - p0[2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0), t, u, v


def _tri_planes(geom, o, d):
    """Every ray (V3 of (N,)) against every triangle: (N, P) planes."""
    col = lambda w: (w.x[:, None], w.y[:, None], w.z[:, None])
    row = lambda a: (a[None, :, 0], a[None, :, 1], a[None, :, 2])
    return mt_planes(col(o), col(d), row(geom.tri_p0), row(geom.tri_e1),
                     row(geom.tri_e2))


def _tri_best_v(geom, o, d, tmin, tmax):
    """Closest triangle per ray: (idx, t, u, v, found), ties to the lowest
    index like ``intersect_brute``."""
    hit, t, u, v = _tri_planes(geom, o, d)
    hit = hit & (t > tmin[:, None]) & (t < tmax[:, None])
    tm = jnp.where(hit, t, BIG)
    tbest = jnp.min(tm, axis=1)
    lane = jax.lax.broadcasted_iota(Int, tm.shape, 1)
    idx = jnp.min(jnp.where(tm == tbest[:, None], lane, IBIG), axis=1)
    pick = lane == idx[:, None]
    ub = jnp.sum(jnp.where(pick, u, 0.0), axis=1)
    vb = jnp.sum(jnp.where(pick, v, 0.0), axis=1)
    found = tbest < BIG
    return jnp.where(found, idx, 0), tbest, ub, vb, found


def _tri_any_v(geom, o, d, tmin, tmax):
    hit, t, _, _ = _tri_planes(geom, o, d)
    hit = hit & (t > tmin[:, None]) & (t < tmax[:, None])
    return jnp.any(hit, axis=1)


def intersect_v(geom: Geometry, o, d, tmin, tmax, bvh: FlatBVH | None = None,
                clusters=None, active=None, coherent=False) -> Hit:
    """Closest-hit over component-SoA rays (o, d: V3 of flat (N,) arrays).

    Canonical hot-path entry: brute-force scenes stay in component form
    end to end; large-scene paths stack to (N,3) for the accelerator walk.
    ``active`` masks lanes off on the hierarchy path (sparse bounce
    wavefronts); ``coherent`` flags camera-bundle workloads (enables the
    hierarchy's full-width prologue)."""
    from ..core import v3 as v

    if not _brute(geom, bvh, clusters):
        return intersect(geom, o.to_array(), d.to_array(), tmin, tmax,
                         bvh=bvh, clusters=clusters, active=active,
                         coherent=coherent)

    R = o.x.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, Float), (R,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, Float), (R,))
    with jax.named_scope("closest_hit"):
        ti, tbest, tu, tv, tvalid = _tri_best_v(geom, o, d, tmin, tmax)
        si, sbest, svalid = _sphere_best_v(geom, o, d, tmin, tmax)
        di, dbest, dvalid = _disk_best_v(geom, o, d, tmin, tmax)

    tbest = jnp.where(tvalid, tbest, BIG)
    best = jnp.minimum(jnp.minimum(tbest, sbest), dbest)
    kind = jnp.where(
        best >= BIG, KIND_NONE,
        jnp.where(tbest == best, KIND_TRI,
                  jnp.where(sbest == best, KIND_SPHERE, KIND_DISK)),
    ).astype(Int)
    prim = jnp.where(kind == KIND_TRI, ti,
                     jnp.where(kind == KIND_SPHERE, si, di))
    shape = jnp.where(
        kind == KIND_TRI,
        v.gather_col(geom.tri_shape,
                     jnp.clip(prim, 0, geom.tri_shape.shape[0] - 1)),
        jnp.where(
            kind == KIND_SPHERE,
            v.gather_col(geom.sph_shape,
                         jnp.clip(prim, 0, geom.sph_shape.shape[0] - 1)),
            v.gather_col(geom.disk_shape,
                         jnp.clip(prim, 0, geom.disk_shape.shape[0] - 1)),
        ),
    )
    return Hit(
        t=jnp.where(kind == KIND_NONE, BIG, best),
        kind=kind,
        prim=jnp.where(kind == KIND_NONE, 0, prim).astype(Int),
        shape=jnp.where(kind == KIND_NONE, INVALID, shape).astype(Int),
        u=jnp.where(kind == KIND_TRI, tu, 0.0),
        v=jnp.where(kind == KIND_TRI, tv, 0.0),
    )


def occluded_v(geom: Geometry, o, d, tmin, tmax, bvh: FlatBVH | None = None,
               clusters=None, active=None) -> jax.Array:
    """Any-hit over component-SoA rays."""
    if not _brute(geom, bvh, clusters):
        return occluded(geom, o.to_array(), d.to_array(), tmin, tmax,
                        bvh=bvh, clusters=clusters, active=active)

    R = o.x.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, Float), (R,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, Float), (R,))
    with jax.named_scope("any_hit"):
        blocked = _tri_any_v(geom, o, d, tmin, tmax)
        _, _, sh = _sphere_best_v(geom, o, d, tmin, tmax)
        _, _, dh = _disk_best_v(geom, o, d, tmin, tmax)
    return blocked | sh | dh


def occluded(geom: Geometry, o, d, tmin, tmax, bvh: FlatBVH | None = None,
             clusters=None, active=None) -> jax.Array:
    """Any-hit (shadow ray) query -> bool per ray."""
    R = o.shape[0]
    o_b, d_b = o[:, None, :], d[:, None, :]
    tmin_b = jnp.broadcast_to(jnp.asarray(tmin, Float), (R,))[:, None]
    tmax_b = jnp.broadcast_to(jnp.asarray(tmax, Float), (R,))[:, None]
    with jax.named_scope("any_hit"):
        if _brute(geom, bvh, clusters):
            th, *_ = _moeller_trumbore(
                o_b, d_b, geom.tri_p0[None], geom.tri_e1[None],
                geom.tri_e2[None], tmin_b, tmax_b,
            )
            blocked = jnp.any(th, axis=-1)
        elif _use_hierarchy(bvh, clusters):
            sg = jax.lax.stop_gradient
            blocked = _dispatch_clusters(clusters, sg(o), sg(d), sg(tmin),
                                         sg(tmax), any_hit=True,
                                         active=active)["found"]
        else:
            blocked = intersect_bvh(bvh, geom, o, d, tmin, tmax,
                                    any_hit=True)["found"]
    sh, _ = _sphere_test(
        o_b, d_b, geom.sph_center[None], geom.sph_radius[None], tmin_b, tmax_b
    )
    dh, _ = _disk_test(
        o_b, d_b, geom.disk_center[None], geom.disk_n[None], geom.disk_s[None],
        geom.disk_t[None], geom.disk_radius[None], tmin_b, tmax_b,
    )
    return blocked | jnp.any(sh, axis=-1) | jnp.any(dh, axis=-1)
