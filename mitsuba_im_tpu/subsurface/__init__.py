"""Subsurface scattering: the classic Jensen dipole BSSRDF.

Parity target: ``/root/reference/src/subsurface/dipole.cpp`` — irradiance
is gathered at sample points distributed over the surface (the reference
uses blue-noise placement + an irradiance octree, ``irrtree.cpp``,
``bluenoise.cpp``) and turned into outgoing radiance through the dipole
diffusion profile Rd(r) (Jensen et al. 2001).

Wavefront redesign: the hierarchical octree's job is to cull far-away
contributions; over a wavefront a **dense chunked sum** over all sample
points is exact and regular — evaluating Rd for (N lanes x P points) is a
pure broadcast/reduce that XLA fuses, so the octree disappears.  Surface points are area-weighted samples of the
shape's triangles (host-side), their irradiance is one batched NEE
wavefront (device), and shading adds Lo = Ft(wo)/pi * sum_p Rd(|x-x_p|)
E_p A_p for lanes whose shape carries a subsurface record.

``singlescatter`` (``src/subsurface/singlescatter.cpp``, Holzschuch 2015)
is a *real* refracted-ray estimator here (:func:`eval_lo_single`): the view
ray refracts into the medium, a scatter distance is importance-sampled
against extinction (normalized to the boundary-exit distance found with a
wavefront ray cast), light is connected through the boundary with Jensen's
corrected internal path length and Fresnel transmittances at both
interfaces, and an occlusion ray guards the external segment.  The
reference's recursive internal-reflection ladder is truncated at one
internal segment (the dominant term); this is the documented deviation.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int, INVALID, EPSILON, SHADOW_EPSILON
from ..core.registry import register
from ..core.properties import Properties


def _rec(props: Properties, single: bool = False) -> dict:
    sigma_s = np.asarray(props.get_spectrum("sigmaS", [2.6, 3.2, 3.9]))
    sigma_a = np.asarray(props.get_spectrum("sigmaA", [0.0021, 0.0041, 0.0071]))
    scale = props.get_float("scale", 1.0)
    return dict(
        sigma_s=sigma_s * scale,
        sigma_a=sigma_a * scale,
        g=props.get_float("g", 0.0),
        eta=props.get_float("intIOR", 1.33) / props.get_float("extIOR", 1.0),
        single=single,
    )


@register("subsurface", "dipole")
def _dipole(props: Properties, ctx=None):
    rec = _rec(props)
    if ctx is not None:
        return ctx.add_subsurface(rec)
    return rec


@register("subsurface", "singlescatter")
def _singlescatter(props: Properties, ctx=None):
    rec = _rec(props, single=True)
    if ctx is not None:
        return ctx.add_subsurface(rec)
    return rec


# ---------------------------------------------------------------------------
# Dipole diffusion profile
# ---------------------------------------------------------------------------

def dipole_coeffs(sigma_s, sigma_a, g, eta):
    """Classical dipole parameters (dipole.cpp configure()).

    Returns dict of per-channel arrays: sigma_tr, zr, zv, alpha_prime.
    """
    sigma_s = np.asarray(sigma_s, np.float64)
    sigma_a = np.asarray(sigma_a, np.float64)
    sigma_sp = sigma_s * (1.0 - g)          # reduced scattering
    sigma_tp = sigma_sp + sigma_a           # reduced extinction
    alpha_p = sigma_sp / np.maximum(sigma_tp, 1e-12)
    sigma_tr = np.sqrt(3.0 * sigma_a * sigma_tp)
    # internal diffuse reflectance (Groenhuis/Egan approximation)
    fdr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    A = (1.0 + fdr) / (1.0 - fdr)
    zr = 1.0 / np.maximum(sigma_tp, 1e-12)
    zv = zr * (1.0 + 4.0 / 3.0 * A)
    return dict(sigma_tr=sigma_tr, zr=zr, zv=zv, alpha_p=alpha_p,
                fdr=fdr, eta=eta)


def rd_profile(r2, sigma_tr, zr, zv, alpha_p):
    """Diffuse reflectance Rd(r) of the dipole (Jensen 2001 eq. 4);
    r2: (...,) squared radius; coefficient args broadcast per channel."""
    dr = jnp.sqrt(r2[..., None] + zr * zr)
    dv = jnp.sqrt(r2[..., None] + zv * zv)
    c1 = zr * (sigma_tr * dr + 1.0) * jnp.exp(-sigma_tr * dr) / (dr ** 3)
    c2 = zv * (sigma_tr * dv + 1.0) * jnp.exp(-sigma_tr * dv) / (dv ** 3)
    return alpha_p / (4.0 * jnp.pi) * (c1 + c2)


def total_diffuse_reflectance(alpha_p, A):
    """Closed-form integral of Rd over the plane (dipole albedo check)."""
    alpha_p = np.asarray(alpha_p, np.float64)
    e = np.sqrt(3.0 * (1.0 - alpha_p))
    return alpha_p / 2.0 * (1.0 + np.exp(-4.0 / 3.0 * A * e)) * np.exp(-e)


def _fresnel_t(eta, cos_i):
    """1 - Fr(eta, cos_i) for the outgoing boundary transmission."""
    ci = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)
    st2 = (1.0 - ci * ci) / (eta * eta)
    tir = st2 >= 1.0
    ct = jnp.sqrt(jnp.maximum(1.0 - st2, 0.0))
    rs = (ci - eta * ct) / jnp.maximum(ci + eta * ct, 1e-12)
    rp = (eta * ci - ct) / jnp.maximum(eta * ci + ct, 1e-12)
    fr = jnp.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    return 1.0 - fr


# ---------------------------------------------------------------------------
# Device table
# ---------------------------------------------------------------------------

@pytree_dataclass
class SubsurfaceTable:
    """Per-record dipole coefficients + shared irradiance point cloud."""

    sigma_tr: jax.Array  # (R, 3)
    zr: jax.Array
    zv: jax.Array
    alpha_p: jax.Array
    eta: jax.Array  # (R,)
    sigma_s: jax.Array  # (R, 3) raw scattering coefficient
    sigma_t: jax.Array  # (R, 3) raw extinction
    g: jax.Array  # (R,) HG anisotropy
    single: jax.Array  # (R,) 1 = singlescatter record, 0 = dipole
    pts: jax.Array  # (P, 3) surface sample points
    irr: jax.Array  # (P, 3) irradiance at the points
    area: jax.Array  # (P,) area weight per point
    pt_rec: jax.Array  # (P,) subsurface record id owning the point
    pt_order: jax.Array  # (P,) point ids sorted by spatial hash bucket
    pt_bucket: jax.Array  # (P,) sorted bucket ids
    cell: jax.Array  # () grid cell size (~4 diffusion lengths)
    n_points: int = static_field(default=0)
    chunk: int = static_field(default=256)
    has_single: bool = static_field(default=False)
    grid_cap: int = static_field(default=64)


def sample_surface_points(builder_tri: dict, shape_ids: list[int],
                          n_points: int, rng: np.random.Generator):
    """Area-weighted triangle sampling over the given shapes (host).
    Returns (points (P,3), normals (P,3), total_area)."""
    tri_shape = np.concatenate([np.asarray(a) for a in builder_tri["shape"]]) \
        if builder_tri["shape"] else np.zeros(0, np.int32)
    mask = np.isin(tri_shape, shape_ids)
    p0 = np.concatenate(builder_tri["p0"])[mask]
    e1 = np.concatenate(builder_tri["e1"])[mask]
    e2 = np.concatenate(builder_tri["e2"])[mask]
    if len(p0) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3)), 0.0
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = areas.sum()
    pmf = areas / max(total, 1e-20)
    idx = rng.choice(len(p0), size=n_points, p=pmf)
    u = rng.uniform(size=(n_points, 2))
    su = np.sqrt(u[:, :1])
    b0 = 1.0 - su
    b1 = u[:, 1:] * su
    pts = p0[idx] + e1[idx] * b0 + e2[idx] * b1
    nrm = np.cross(e1[idx], e2[idx])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return pts, nrm, float(total)


def compute_irradiance(scene, pts, nrm, n_samples: int = 8, seed: int = 7):
    """Direct irradiance at the sample points: one batched NEE wavefront
    per sample (the irradiance-octree fill analog, dipole.cpp preprocess)."""
    from ..core import rng as mrng
    from ..core import math as m
    from ..emitter import table as em

    p = jnp.asarray(pts, Float)
    n = jnp.asarray(nrm, Float)
    P = p.shape[0]
    acc = jnp.zeros((P, 3), Float)
    for si in range(n_samples):
        s = mrng.make_sampler(jnp.arange(P, dtype=jnp.uint32),
                              jnp.uint32(si), jnp.uint32(seed))
        s, blk = mrng.next_block4(s)
        ds = em.sample_direct(scene.emitters, scene.geom, p, blk[..., 0],
                              blk[..., 1:3])
        cos_i = jnp.maximum(m.dot(n, ds.d), 0.0)
        occ = scene.occluded(p + n * 1e-4, ds.d, EPSILON,
                             ds.dist * (1.0 - SHADOW_EPSILON))
        ok = (ds.pdf > 0) & ~occ & (cos_i > 0)
        contrib = ds.value * (cos_i / jnp.maximum(ds.pdf, 1e-20))[..., None]
        acc = acc + jnp.where(ok[..., None], contrib, 0.0)
    return acc / n_samples


def build_subsurface(records: list[dict], builder, scene,
                     points_per_record: int = 512) -> SubsurfaceTable | None:
    """Assemble the table after the scene exists (needs emitters + BVH)."""
    if not records:
        return None
    rng = np.random.default_rng(11)
    all_pts, all_nrm, all_area, all_rec = [], [], [], []
    for rid, rec in enumerate(records):
        if rec.get("single"):
            continue  # singlescatter records use the refracted-ray estimator
        shape_ids = [sid for sid, ss in enumerate(builder.shape_subsurface)
                     if ss == rid]
        pts, nrm, area = sample_surface_points(
            builder._tri, shape_ids, points_per_record, rng)
        if len(pts) == 0:
            continue
        all_pts.append(pts)
        all_nrm.append(nrm)
        all_area.append(np.full(len(pts), area / len(pts), np.float32))
        all_rec.append(np.full(len(pts), rid, np.int32))
    if all_pts:
        pts = np.concatenate(all_pts)
        nrm = np.concatenate(all_nrm)
        irr = np.asarray(compute_irradiance(scene, pts, nrm))
        area = np.concatenate(all_area)
        recs_arr = np.concatenate(all_rec)
    elif any(r.get("single") for r in records):
        pts = np.zeros((0, 3))
        nrm = np.zeros((0, 3))
        irr = np.zeros((0, 3), np.float32)
        area = np.zeros(0, np.float32)
        recs_arr = np.zeros(0, np.int32)
    else:
        return None
    # pad to a chunk multiple (the gather slices fixed-size chunks; padded
    # rows carry rec id -1 so the same-record mask drops them)
    C = 256
    pad = (-len(pts)) % C
    if pad:
        pts = np.concatenate([pts, np.zeros((pad, 3))])
        irr = np.concatenate([irr, np.zeros((pad, 3), np.float32)])
        area = np.concatenate([area, np.zeros(pad, np.float32)])
        recs_arr = np.concatenate([recs_arr, np.full(pad, -1, np.int32)])

    co = [dipole_coeffs(r["sigma_s"], r["sigma_a"], r["g"], r["eta"])
          for r in records]
    f = lambda k: jnp.asarray(np.stack([c[k] for c in co]), Float)

    # spatial hash grid over the sample points (the octree-culling analog,
    # irrtree.cpp): cell ~ 4 diffusion lengths of the widest profile, so a
    # 27-cell scan covers everything the dipole kernel can still see
    sigma_tr_min = min((float(np.min(c["sigma_tr"])) for c in co),
                       default=1.0)
    cell = 4.0 / max(sigma_tr_min, 1e-3)
    from ..integrators.sppm import build_grid

    P_tot = len(pts)
    if P_tot:
        order, bucket = build_grid(
            jnp.asarray(pts, Float),
            jnp.asarray(recs_arr >= 0), jnp.asarray(cell, Float))
    else:
        order = jnp.zeros((0,), Int)
        bucket = jnp.zeros((0,), jnp.uint32)
    return SubsurfaceTable(
        sigma_tr=f("sigma_tr"), zr=f("zr"), zv=f("zv"), alpha_p=f("alpha_p"),
        eta=jnp.asarray([c["eta"] for c in co], Float),
        sigma_s=jnp.asarray(np.stack([r["sigma_s"] for r in records]), Float),
        sigma_t=jnp.asarray(
            np.stack([np.asarray(r["sigma_s"]) + np.asarray(r["sigma_a"])
                      for r in records]), Float),
        g=jnp.asarray([r["g"] for r in records], Float),
        single=jnp.asarray([1 if r.get("single") else 0 for r in records],
                           Int),
        pts=jnp.asarray(pts, Float), irr=jnp.asarray(irr, Float),
        area=jnp.asarray(area, Float),
        pt_rec=jnp.asarray(recs_arr, Int),
        pt_order=order, pt_bucket=bucket,
        cell=jnp.asarray(cell, Float),
        n_points=len(pts),
        chunk=C,
        has_single=any(bool(r.get("single")) for r in records),
    )


def eval_lo(table: SubsurfaceTable, x, wo_cos, rec_id):
    """Outgoing subsurface radiance at shading points x (N, 3).

    wo_cos: |cos| of the outgoing direction against the shading normal;
    rec_id: (N,) the subsurface record at each lane (INVALID = none).

    Small point clouds use the exact dense chunked sum; larger ones scan
    the 27-neighborhood of the spatial hash grid (cell = 4 diffusion
    lengths), the wavefront analog of the reference's irradiance octree culling
    (``irrtree.cpp``) — the dropped tail beyond 4/sigma_tr carries
    ~e^-4 of the profile's energy.  Cell overflow beyond ``grid_cap`` is
    uniformly subsampled and reweighted (unbiased, sppm.py pattern).
    """
    N = x.shape[0]
    P = table.n_points
    active = rec_id >= 0
    rid = jnp.clip(rec_id, 0, table.sigma_tr.shape[0] - 1)
    sigma_tr = table.sigma_tr[rid]
    zr = table.zr[rid]
    zv = table.zv[rid]
    alpha_p = table.alpha_p[rid]
    eta = table.eta[rid]

    mo = jnp.zeros((N, 3), Float)
    if P <= 1024:  # dense exact path
        C = min(table.chunk, max(P, 1))
        n_chunks = (P + C - 1) // C
        for ci in range(n_chunks):
            pp = jax.lax.dynamic_slice_in_dim(table.pts, ci * C, C, 0)
            ee = jax.lax.dynamic_slice_in_dim(table.irr, ci * C, C, 0)
            aa = jax.lax.dynamic_slice_in_dim(table.area, ci * C, C, 0)
            rr = jax.lax.dynamic_slice_in_dim(table.pt_rec, ci * C, C, 0)
            d = x[:, None, :] - pp[None, :, :]          # (N, C, 3)
            r2 = jnp.sum(d * d, axis=-1)                 # (N, C)
            rd = rd_profile(r2, sigma_tr[:, None, :], zr[:, None, :],
                            zv[:, None, :], alpha_p[:, None, :])  # (N, C, 3)
            same = (rr[None, :] == rec_id[:, None]) & (rr[None, :] >= 0)
            w = jnp.where(same[..., None], rd * aa[None, :, None], 0.0)
            mo = mo + jnp.sum(w * ee[None, :, :], axis=1)
    else:
        from ..integrators.sppm import _cell_hash

        cap = table.grid_cap
        base = jnp.floor(x / table.cell).astype(jnp.int32)
        offs = jnp.asarray(
            [[dx_, dy_, dz_] for dz_ in (-1, 0, 1) for dy_ in (-1, 0, 1)
             for dx_ in (-1, 0, 1)], jnp.int32)
        cc = base[None, :, :] + offs[:, None, :]
        b = _cell_hash(cc)
        starts = jnp.searchsorted(table.pt_bucket, b, side="left")
        ends = jnp.searchsorted(table.pt_bucket, b, side="right")
        fulls = ends - starts
        runs = jnp.minimum(fulls, cap)

        def body(j, mo):
            ci = j // cap
            k = j % cap
            start = jax.lax.dynamic_index_in_dim(starts, ci, 0,
                                                 keepdims=False)
            run = jax.lax.dynamic_index_in_dim(runs, ci, 0, keepdims=False)
            full = jax.lax.dynamic_index_in_dim(fulls, ci, 0, keepdims=False)
            idx = jnp.minimum(start + k, P - 1)
            pid = table.pt_order[idx]
            ok = k < run
            over = (full.astype(Float)
                    / jnp.maximum(run.astype(Float), 1.0))
            d = x - table.pts[pid]
            r2 = jnp.sum(d * d, axis=-1)
            rd = rd_profile(r2, sigma_tr, zr, zv, alpha_p)  # (N, 3)
            same = (table.pt_rec[pid] == rec_id) & (table.pt_rec[pid] >= 0)
            w = jnp.where((ok & same)[..., None],
                          rd * (table.area[pid] * over)[..., None], 0.0)
            return mo + w * table.irr[pid]

        mo = jax.lax.fori_loop(0, 27 * cap, body, mo)

    ft = _fresnel_t(eta, wo_cos)
    lo = mo * (ft / jnp.pi)[..., None]
    return jnp.where(active[..., None], lo, 0.0)


def eval_lo_single(table: SubsurfaceTable, scene, p, ns, d_world, rec_id,
                   blk):
    """Refracted-ray single-scatter estimator (singlescatter.cpp LoSingle).

    p, ns, d_world: V3 wavefront arrays (position, shading normal, incoming
    ray direction pointing INTO the surface); rec_id: (N,) subsurface record
    (INVALID = none); blk: 4 uniform randoms (distance + light sample).
    Returns V3 outgoing radiance; one sample per lane per bounce.
    """
    from ..core import v3 as v
    from ..emitter import table as em

    N = p.x.shape[0]
    R = table.sigma_tr.shape[0]
    rid = jnp.clip(rec_id, 0, R - 1)
    is_single = table.single[rid] > 0
    active = (rec_id >= 0) & is_single
    eta = table.eta[rid]
    inv_eta = 1.0 / eta
    sig_s = table.sigma_s[rid]  # (N, 3)
    sig_t = table.sigma_t[rid]
    g = table.g[rid]

    # refract the view ray into the medium across the shading normal
    cos_i = -(d_world.dot(ns))
    active = active & (cos_i > 0)
    sin2t = (1.0 - cos_i * cos_i) * inv_eta * inv_eta
    tir = sin2t >= 1.0
    ct = jnp.sqrt(jnp.maximum(1.0 - sin2t, 0.0))
    wr = (d_world * inv_eta + ns * (cos_i * inv_eta - ct)).normalized()
    ft_in = _fresnel_t(eta, cos_i)
    active = active & ~tir

    # boundary-exit distance along the refracted ray (wavefront cast)
    o_in = p - ns * 1e-4
    hx = scene.ray_intersect_v(o_in, wr)
    t_exit = jnp.where(hx.t < 1e30, hx.t, 0.0)
    active = active & (t_exit > 1e-6)

    # distance importance-sampled against mean extinction, normalized to
    # the inside segment [0, t_exit] (zero wasted samples)
    sbar = jnp.maximum((sig_t[:, 0] + sig_t[:, 1] + sig_t[:, 2]) / 3.0, 1e-6)
    fmax = 1.0 - jnp.exp(-sbar * t_exit)
    u1 = jnp.clip(blk[0], 0.0, 1.0 - 1e-6)
    s_dist = -jnp.log(1.0 - u1 * fmax) / sbar
    s_dist = jnp.minimum(s_dist, t_exit * (1.0 - 1e-5))
    pdf_s = sbar * jnp.exp(-sbar * s_dist) / jnp.maximum(fmax, 1e-12)
    xs = o_in + wr * s_dist

    # light connection at the internal point
    ds = em.sample_direct_v(scene.emitters, scene.geom, xs,
                            blk[1], blk[2], blk[3])
    he = scene.ray_intersect_v(xs, ds.d)
    ie = scene.interaction_v(xs, ds.d, he)
    si = he.t
    exit_ok = ie.valid & (si < ds.dist) & (ds.pdf > 0)
    cos_e = jnp.abs(ie.ns.dot(ds.d))

    # Jensen's corrected internal path length (dipole paper eq. 6): the
    # true refracted internal segment is longer than the straight one
    denom = jnp.sqrt(jnp.maximum(
        1.0 - inv_eta * inv_eta * (1.0 - cos_e * cos_e), 1e-6))
    si_p = si * cos_e / denom
    ft_out = _fresnel_t(inv_eta, cos_e)

    # occlusion of the external segment (exit point -> light)
    x_e = xs + ds.d * si
    occ = scene.occluded_v(x_e + ds.d * 1e-4, ds.d, EPSILON,
                           jnp.maximum(ds.dist - si, 0.0)
                           * (1.0 - SHADOW_EPSILON))

    # Henyey-Greenstein phase between the internal segments
    cos_ph = wr.dot(ds.d)
    ph = (1.0 - g * g) / jnp.maximum(
        4.0 * jnp.pi * (1.0 + g * g - 2.0 * g * cos_ph) ** 1.5, 1e-12)

    tr = jnp.exp(-(s_dist[:, None] + si_p[:, None]) * sig_t)  # (N, 3)
    scale = ft_in * ft_out * ph / (jnp.maximum(pdf_s, 1e-20)
                                   * jnp.maximum(ds.pdf, 1e-20))
    w = v.V3.from_array(sig_s * tr) * scale
    lo = ds.value * w
    ok = active & exit_ok & ~occ
    return v.where(ok, lo, v.zeros((N,)))
