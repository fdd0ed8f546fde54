"""Bidirectional path tracer with full multiple-importance sampling.

Parity target: ``/root/reference/src/integrators/bdpt/`` built on libbidir
(``include/mitsuba/bidir/{vertex,edge,path}.h``): eye and light subpaths are
traced independently, every (s light, t eye) pairing is connected, and each
strategy's contribution is weighted by the balance heuristic over all
strategies that could have produced the same path (Veach's MIS; the
reference computes it via ``Path::misWeight``).

Wavefront redesign (SURVEY.md §7): the reference's pointer-linked
``PathVertex``/``PathEdge`` chains become **fixed-depth SoA vertex arrays**
— one dict of (N,)/(N,3) arrays per static vertex index, built by a
statically unrolled random walk over the whole wavefront.  Every (s,t)
strategy is evaluated for ALL lanes at once (one shadow-ray wavefront + two
batched BSDF evals per strategy); the MIS weight is computed with the
PBRT-style pdfFwd/pdfRev bookkeeping (ratios of area-measure densities,
``remap0`` for delta vertices), where all vertex indices are static so no
dynamic gathers appear anywhere.

Strategy taxonomy (path with k = s + t - 1 edges <= maxDepth):
  - s=0           : eye path hits an emitter (incl. env escape, weighted
                    against s=1 with the balance heuristic)
  - s=1, t>=2     : next-event estimation — re-sample a light point from
                    the eye vertex (lower variance than reusing the light
                    subpath's origin, as in the reference / PBRT)
  - t=1, s>=2     : light tracing — connect a light vertex to the camera,
                    splatting to arbitrary pixels (the reference's
                    light-image, ``bdpt_wr.cpp``)
  - s>=2, t>=2    : inner connection with geometry term + visibility

Light subpaths apply Veach's shading-normal asymmetry correction
(:func:`_adjoint_correction`, ``include/mitsuba/bidir/vertex.h:272-408``)
both along the walk and at connection vertices.

Light subpaths start from every emitter type, including environment /
constant / directional lights (``include/mitsuba/bidir/vertex.h:272-408``
``sampleNext`` handles all emitter types): infinite emitters sample a
direction (env 2D-CDF / uniform sphere / delta) then a point on the
perpendicular scene-bounding disk, and all densities touching the infinite
origin stay in the solid-angle measure while the first surface vertex uses
the parallel-beam area density (disk pdf x |cos|).  Environment escapes are
weighted as s=0 strategies with a pseudo-vertex at infinity against both
NEE-env and the light-connection strategies.

Participating media (rounds 4-5, ``include/mitsuba/bidir/vertex.h:48``
``EMediumInteraction`` + ``edge.h:32-76`` ``PathEdge`` analog): subpath
walks place **medium vertices** — lanes whose per-lane medium scatters
(sigma_s > 0) sample a channel-averaged free-flight distance each step;
when it beats the surface hit the slot becomes a volume interaction that
continues by phase-function sampling, with volume-measure forward and
reverse densities (distance pdf x 1/d^2) carried through the same MIS
bookkeeping as surfaces (:func:`_conv_density`).  Every connection
strategy evaluates ``sigma_s x phase`` at medium vertices vs the BSDF at
surface vertices (:func:`_vertex_f`), edges carry full-sigma_t
transmittance with per-lane medium ids tracked across boundary
crossings, and heterogeneous grid media are ratio-tracked on connection
edges with a dedicated counter-RNG stream (:func:`_seg_tr`).
Scattering-media scenes agree with volpath
(tests/test_bdpt.py::TestMediaAwareBDPT).  Remaining documented
approximation: a connection edge uses the medium of its eye-side
endpoint for the whole segment (no mid-edge boundary crossings), and
heterogeneous media get ratio-tracked edges but no heterogeneous medium
*vertices* (their tracking has no closed-form pdf for MIS).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import Float, Int, INVALID, EPSILON, SHADOW_EPSILON
from ..core import math as m
from ..core import rng as mrng
from ..core import warp
from ..bsdf.eval import bsdf_eval, bsdf_pdf, bsdf_sample
from ..bsdf.common import lane_is_delta
from ..emitter import table as em
from ..scene.scene import Scene
from ..sensor.table import sample_ray, connect as sensor_connect
from ..film.film import Film, splat as film_splat
from .path import _fake_it

U32 = jnp.uint32
BIG_T = 1.0e30  # "no event" distance sentinel


def _remap0(x):
    return jnp.where(x != 0.0, x, 1.0)


def _dist2(a, b):
    d = b - a
    return jnp.sum(d * d, axis=-1)


def _to_area(pdf_sa, from_p, to_p, to_n):
    """Solid-angle density at ``from_p`` -> area density at ``to_p``."""
    d2 = _dist2(from_p, to_p)
    d = (to_p - from_p) * jax.lax.rsqrt(jnp.maximum(d2, 1e-20))[..., None]
    return pdf_sa * jnp.abs(m.dot(to_n, d)) / jnp.maximum(d2, 1e-20)


def _seg_sigma(scene, mid):
    """Per-lane (sigma_s mean, sigma_t channel-mean) of a segment medium;
    the distance-sampling density sigma-bar is the channel-mean sigma_t of
    *scattering* media only (pure absorbers keep analytic transmittance
    and no distance-sampling densities)."""
    from ..media import medium as med

    ss, st, _pt, _g = med.medium_params(scene.media, mid)
    ss_mean = jnp.mean(ss, axis=-1)
    st_bar = jnp.mean(st, axis=-1)
    return jnp.where(ss_mean > 0, st_bar, 0.0)


def _conv_density(scene, pdf_sa, from_p, to_p, to_n, to_is_med, seg_mid,
                  has_media):
    """Solid-angle density -> area/volume density at ``to_p``, including
    the free-flight factors of the segment medium (PBRT's ConvertDensity
    extended with distance sampling): surface targets pick up the
    survive-to-surface probability e^{-sigma-bar d}, medium targets the
    distance pdf sigma-bar e^{-sigma-bar d} and NO cosine."""
    d2 = _dist2(from_p, to_p)
    dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
    dvec = (to_p - from_p) / dist[..., None]
    cosf = jnp.abs(m.dot(to_n, dvec))
    if not has_media:
        return pdf_sa * cosf / jnp.maximum(d2, 1e-20)
    sbar = _seg_sigma(scene, seg_mid)
    atten = jnp.exp(-sbar * dist)
    fac = jnp.where(to_is_med, sbar * atten, atten)
    cosf = jnp.where(to_is_med, 1.0, cosf)
    return pdf_sa * cosf * fac / jnp.maximum(d2, 1e-20)


def _vertex_f(scene, v, wo_world, has_media, adjoint=False):
    """Scattering throughput at a path vertex toward ``wo_world``:
    BSDF (cosine included, local frame) at surfaces; the phase function at
    medium vertices (``vertex.h:48`` EMediumInteraction analog — sigma_s
    is already folded into ``beta`` at medium-vertex arrival, so the
    vertex's f is the phase alone, PBRT convention)."""
    wo_local = _local(v, wo_world)
    f = bsdf_eval(v["bp"], v["wi_local"], wo_local)
    if adjoint:
        wi_w = _from_local(v, v["wi_local"])
        f = f * _adjoint_correction(v["ns"], v["ng"], wi_w, wo_world)[..., None]
    if not has_media:
        return f
    from ..media import medium as med

    _ss, _st, pt, g = med.medium_params(scene.media, v["mid"])
    ph = med.phase_eval(pt, g, v["wi_world"], wo_world)
    return jnp.where(v["is_med"][..., None], ph[..., None], f)


def _vertex_pdf(scene, v, wo_world, has_media, reverse=False):
    """Solid-angle density of sampling ``wo_world`` at vertex ``v`` (or,
    with ``reverse``, of sampling the arrival direction given wo)."""
    wo_local = _local(v, wo_world)
    if reverse:
        pdf = bsdf_pdf(v["bp"], wo_local, v["wi_local"])
    else:
        pdf = bsdf_pdf(v["bp"], v["wi_local"], wo_local)
    if not has_media:
        return pdf
    from ..media import medium as med

    _ss, _st, pt, g = med.medium_params(scene.media, v["mid"])
    # iso/HG/Rayleigh are sampled proportional to value and reciprocal,
    # so the phase pdf equals its value in either direction
    ph = med.phase_eval(pt, g, v["wi_world"], wo_world)
    return jnp.where(v["is_med"], ph, pdf)


def _from_local(v, w_local):
    """Vertex-frame local direction -> world."""
    return (v["ss"] * w_local[..., 0:1] + v["ts"] * w_local[..., 1:2]
            + v["ns"] * w_local[..., 2:3])


def _local(v, d_world):
    return m.Frame.to_local((v["ss"], v["ts"], v["ns"]), d_world)


def _dir(a, b):
    d = b - a
    return d * jax.lax.rsqrt(jnp.maximum(jnp.sum(d * d, -1), 1e-20))[..., None]


# ---------------------------------------------------------------------------
# Subpath tracing
# ---------------------------------------------------------------------------

def _adjoint_correction(ns, ng, wi_world, wo_world):
    """Veach's shading-normal asymmetry factor for importance transport
    (light subpaths): |wi.ns||wo.ng| / (|wi.ng||wo.ns|), clamped
    (``include/mitsuba/bidir/vertex.h:272-408`` applies the same factor
    when ``EImportance`` transport crosses a shading-normal frame)."""
    num = jnp.abs(m.dot(wi_world, ns)) * jnp.abs(m.dot(wo_world, ng))
    den = jnp.abs(m.dot(wi_world, ng)) * jnp.abs(m.dot(wo_world, ns))
    return jnp.clip(jnp.where(den > 1e-8, num / jnp.maximum(den, 1e-8), 1.0),
                    0.0, 10.0)


def random_walk(scene: Scene, sampler, o, d, beta0, pdf_dir0, n_steps,
                start_p, start_n, adjoint=False, infinite0=None,
                medium0=None):
    """Extend a subpath by up to ``n_steps`` surface OR medium vertices.

    Returns (vertex list, sampler, escape record).  Each vertex dict holds
    geometry, the resolved BSDF LaneParams, throughput ``beta`` (up to and
    including arrival), area/volume-measure ``pdf_fwd``, reverse density
    ``pdf_rev`` (at THIS vertex as if sampled backward), and flags.
    The walk also fills ``prev_pdf_rev`` slots one step behind, and reports
    escaped lanes (for environment handling) with their direction + pdf.

    ``medium0``: optional (N,) per-lane starting medium ids.  Lanes inside
    a *scattering* medium sample a channel-averaged free-flight distance
    each step (one extra RNG block per step when the scene has media);
    when it beats the surface hit the slot becomes a medium vertex
    (``is_med``) that continues by phase sampling, with the distance pdf
    folded into forward/reverse densities (:func:`_conv_density`).  Pure
    absorbers keep analytic Beer-Lambert throughput with no density
    factors; medium ids track across boundary crossings and each vertex
    records its arrival-side medium in ``mid``.
    """
    from ..media import medium as med

    verts = []
    s = sampler
    prev_p, prev_n = start_p, start_n
    cur_d = d
    beta = beta0
    pdf_dir = pdf_dir0
    pdf_delta = jnp.zeros(pdf_dir0.shape, bool)
    alive = jnp.ones(pdf_dir0.shape, bool)
    escape = None
    mid = medium0
    n0 = start_p.shape[0]
    zf = jnp.zeros((n0,), Float)
    prev_is_med = jnp.zeros((n0,), bool)

    for i in range(n_steps):
        hit = scene.ray_intersect(prev_p, cur_d)
        it = scene.interaction(prev_p, cur_d, hit)
        surf_ok = alive & it.valid

        if mid is not None:
            # free-flight sampling in scattering media: channel-mean
            # sigma_t density; pure absorbers keep analytic Beer-Lambert
            s, mblk = mrng.next_block4(s)
            ss_m, st_m, pt_m, g_m = med.medium_params(scene.media, mid)
            sbar = _seg_sigma(scene, mid)
            t_m = jnp.where(
                sbar > 0,
                -jnp.log(jnp.maximum(1.0 - mblk[..., 0], 1e-20))
                / jnp.maximum(sbar, 1e-20), BIG_T)
            t_surf = jnp.where(it.valid, hit.t, BIG_T)
            in_scat = alive & (sbar > 0) & (t_m < t_surf)
            # arrival weights: Tr(t)/pdf — medium: x sigma_s; surface /
            # escape: / survive probability (exact for gray sigma_t)
            t_arr = jnp.where(in_scat, t_m, jnp.minimum(t_surf, hit.t))
            t_fin = jnp.where(in_scat, t_m, t_surf)
            tr_full = med.transmittance(st_m, jnp.minimum(t_fin, 1e30))
            pdf_t = jnp.maximum(sbar, 1e-20) * jnp.exp(-sbar * t_m)
            p_surf = jnp.exp(-sbar * jnp.minimum(t_surf, 1e30))
            w_med = tr_full * (ss_m / pdf_t[..., None])
            w_srf = tr_full / jnp.maximum(p_surf, 1e-20)[..., None]
            w_arr = jnp.where(in_scat[..., None], w_med, w_srf)
            # escaped lanes through infinite medium: transmittance -> 0
            esc_kill = (alive & ~it.valid & ~in_scat)[..., None] & (
                jnp.mean(st_m, -1, keepdims=True) > 0)
            beta = beta * jnp.where((surf_ok | in_scat)[..., None],
                                    w_arr, 1.0)
            beta = jnp.where(esc_kill, 0.0, beta)
            valid = (surf_ok & ~in_scat) | in_scat
            is_med = in_scat
        else:
            valid = surf_ok
            is_med = jnp.zeros((n0,), bool)
            in_scat = is_med

        if i == 0:
            # record escaped primary/secondary rays once (env contribution)
            esc0 = alive & ~it.valid & ~in_scat
            escape = dict(d=cur_d, beta=beta, pdf_dir=pdf_dir,
                          escaped=esc0, delta=pdf_delta,
                          i=jnp.where(esc0, 0, -1))
        else:
            esc_now = alive & ~it.valid & ~in_scat
            escape = dict(
                d=jnp.where(esc_now[..., None], cur_d, escape["d"]),
                beta=jnp.where(esc_now[..., None], beta, escape["beta"]),
                pdf_dir=jnp.where(esc_now, pdf_dir, escape["pdf_dir"]),
                escaped=escape["escaped"] | esc_now,
                delta=jnp.where(esc_now, pdf_delta, escape["delta"]),
                i=jnp.where(esc_now, i, escape["i"]),
            )

        # vertex position/frame: surface interaction or medium point
        if mid is not None:
            p_v = jnp.where(is_med[..., None],
                            prev_p + cur_d * t_arr[..., None], it.p)
            fr_m = m.Frame.from_normal(-cur_d)
            ns_v = jnp.where(is_med[..., None], -cur_d, it.ns)
            ng_v = jnp.where(is_med[..., None], -cur_d, it.ng)
            ss_v = jnp.where(is_med[..., None], fr_m[0], it.ss)
            ts_v = jnp.where(is_med[..., None], fr_m[1], it.ts_)
        else:
            p_v, ns_v, ng_v, ss_v, ts_v = it.p, it.ns, it.ng, it.ss, it.ts_

        bparams = scene.bsdf_at(it)
        pdf_fwd = jnp.where(
            pdf_delta, 0.0,
            _conv_density(scene, pdf_dir, prev_p, p_v, ns_v, is_med, mid,
                          mid is not None))
        if i == 0 and infinite0 is not None:
            # infinite-light origin (env/directional/constant): the first
            # segment is a parallel beam from the bounding disk — density
            # per area is pdf_pos * |cos|, no 1/d^2 (vertex.h:272 analog of
            # PBRT's infinite-light convention)
            pdf_inf = pdf_dir * jnp.abs(m.dot(ns_v, cur_d))
            pdf_fwd = jnp.where(infinite0, pdf_inf, pdf_fwd)
        v = dict(
            p=p_v, ns=ns_v, ng=ng_v, ss=ss_v, ts=ts_v, uv=it.uv,
            shape=jnp.where(is_med, INVALID, it.shape),
            wi_local=it.wi_local, bp=bparams,
            beta=beta, pdf_fwd=pdf_fwd, pdf_rev=jnp.zeros_like(pdf_fwd),
            delta=lane_is_delta(bparams) & ~is_med, valid=valid,
            emitter=jnp.where(is_med, -1, scene.emitter_at(it)),
            mid=mid, is_med=is_med, wi_world=-cur_d,
        )

        s, blk = mrng.next_block4(s)
        bs = bsdf_sample(bparams, it.wi_local, blk[..., 0], blk[..., 1:3],
                         blk[..., 3])
        frame = (ss_v, ts_v, ns_v)
        wo_surf = m.Frame.to_world((it.ss, it.ts_, it.ns), bs.wo)
        if mid is not None:
            wo_ph, pdf_ph = med.phase_sample(pt_m, g_m, -cur_d,
                                             mblk[..., 1:3])
            wo_world = jnp.where(is_med[..., None], wo_ph, wo_surf)
            pdf_out = jnp.where(is_med, pdf_ph,
                                jnp.where(bs.delta, 0.0, bs.pdf))
            out_delta = bs.delta & ~is_med
            w_step = jnp.where(is_med[..., None], 1.0, bs.weight)
        else:
            wo_world = wo_surf
            pdf_out = jnp.where(bs.delta, 0.0, bs.pdf)
            out_delta = bs.delta
            w_step = bs.weight

        # reverse pdf of re-sampling the arrival direction given wo
        pdf_rev_sa = _vertex_pdf(scene, v, wo_world, mid is not None,
                                 reverse=True)
        pdf_rev_sa = jnp.where(out_delta, 0.0, pdf_rev_sa)
        prev_rev = _conv_density(scene, pdf_rev_sa, p_v, prev_p, prev_n,
                                 prev_is_med, mid, mid is not None)
        if i == 0:
            start_rev = prev_rev  # reverse density at the subpath origin
            if infinite0 is not None:
                # toward an infinite origin the reverse density stays in
                # solid angle (directions are the measure at infinity)
                start_rev = jnp.where(infinite0, pdf_rev_sa, start_rev)
        else:
            verts[i - 1]["pdf_rev"] = jnp.where(
                valid, prev_rev, verts[i - 1]["pdf_rev"])

        beta = beta * w_step
        if adjoint:
            # importance transport: shading-normal asymmetry correction
            # (surfaces only; media have no shading frames)
            corr = _adjoint_correction(it.ns, it.ng, -cur_d, wo_world)
            corr = jnp.where(is_med, 1.0, corr)
            beta = beta * jnp.where(valid, corr, 1.0)[..., None]
        pdf_dir = pdf_out
        pdf_delta = out_delta
        alive = valid & (jnp.sum(jnp.abs(w_step), -1) > 0)
        if mid is not None:
            mid = jnp.where(
                valid & ~is_med,
                _medium_transition(scene, it.shape, wo_world, it.ng, mid),
                mid)
        prev_p, prev_n = p_v, ns_v
        prev_is_med = is_med
        cur_d = wo_world
        verts.append(v)

    if n_steps == 0:
        escape = dict(d=d, beta=beta0, pdf_dir=pdf_dir0,
                      escaped=jnp.zeros((n0,), bool),
                      delta=jnp.zeros((n0,), bool),
                      i=jnp.full((n0,), -1, Int))
        start_rev = jnp.zeros((n0,), Float)
    return verts, s, escape, start_rev


def sample_light_origin(scene: Scene, u_sel, u_pos, u_dir):
    """Sample the light-subpath origin with separated densities.

    Returns a vertex-0 dict with pdf_fwd = select_pmf * pdf_pos (area
    measure), the emission direction + its solid-angle pdf, and Le.  Lanes
    that select emitter types the bidir machinery excludes (env/constant/
    directional/collimated) come back dead — NOT renormalized, so the
    selection pmf in the MIS bookkeeping stays exact.
    """
    emt = scene.emitters
    shape = u_sel.shape
    if emt.select.pmf.shape[0] == 1:
        eid = jnp.zeros(shape, Int)
        sel_pmf = jnp.ones(shape, Float)
    else:
        eid, sel_pmf = emt.select.sample(u_sel)

    from ..core.gather import RowBundle

    eb = (
        RowBundle()
        .add("type", emt.type).add("radiance", emt.radiance)
        .add("intensity", emt.intensity).add("position", emt.position)
        .add("direction", emt.direction).add("total_area", emt.total_area)
        .add("area_kind", emt.area_kind).add("prim", emt.prim)
        .add("cos_cutoff", emt.cos_cutoff).add("cos_falloff", emt.cos_falloff)
    ).lookup(eid)
    etype = eb["type"]

    p = jnp.zeros(shape + (3,), Float)
    n = jnp.zeros(shape + (3,), Float)
    d = jnp.zeros(shape + (3,), Float)
    le = jnp.zeros(shape + (3,), Float)  # radiance (area) / intensity (point)
    pdf_pos = jnp.ones(shape, Float)
    pdf_dir = jnp.zeros(shape, Float)
    delta = jnp.zeros(shape, bool)
    alive = jnp.zeros(shape, bool)
    infinite = jnp.zeros(shape, bool)

    # infinite emitters (env/constant/directional, vertex.h:272 analog):
    # direction first, then a point on the perpendicular bounding disk;
    # the returned pdf slots follow the infinite-light convention —
    # pdf_fwd = sel_pmf * pdf_dir (solid angle), pdf_dir slot = disk pdf.
    r_w = emt.bsphere_radius * 1.05 + 1e-4
    c_w = emt.bsphere_center
    disk_pdf = 1.0 / (jnp.pi * r_w * r_w)

    def disk_origin(d_prop):
        fr = m.Frame.from_normal(d_prop)
        rr = jnp.sqrt(jnp.maximum(u_pos[..., 0], 0.0)) * r_w
        ph = 2.0 * jnp.pi * u_pos[..., 1]
        off = jnp.stack([rr * jnp.cos(ph), rr * jnp.sin(ph),
                         jnp.zeros_like(rr)], axis=-1)
        return c_w - d_prop * r_w + m.Frame.to_world(fr, off)

    for t in emt.used_types:
        sel = etype == t
        if t in (em.EM_ENVMAP, em.EM_CONSTANT, em.EM_DIRECTIONAL):
            if t == em.EM_ENVMAP:
                uv, pdf_uv = emt.env_dist.sample_continuous(u_dir)
                w_esc = em._env_dir_from_uv(emt, uv)  # toward the env
                theta = uv[..., 1] * jnp.pi
                sin_t = jnp.maximum(jnp.sin(theta), 1e-6)
                pdir = pdf_uv / (2.0 * jnp.pi * jnp.pi * sin_t)
                rad = em._env_lookup(emt, uv, eb["radiance"])
                is_delta = jnp.zeros(shape, bool)
            elif t == em.EM_CONSTANT:
                w_esc = warp.square_to_uniform_sphere(u_dir)
                pdir = jnp.full(shape, warp.INV_FOURPI, Float)
                rad = jnp.broadcast_to(eb["radiance"], shape + (3,))
                is_delta = jnp.zeros(shape, bool)
            else:  # directional: delta direction, irradiance payload
                w_esc = jnp.broadcast_to(-eb["direction"], shape + (3,))
                pdir = jnp.ones(shape, Float)
                rad = jnp.broadcast_to(eb["intensity"], shape + (3,))
                is_delta = jnp.ones(shape, bool)
            d_prop = -w_esc
            p_s = disk_origin(d_prop)
            msk = sel[..., None]
            p = jnp.where(msk, p_s, p)
            n = jnp.where(msk, d_prop, n)
            d = jnp.where(msk, d_prop, d)
            le = jnp.where(msk, rad, le)
            pdf_pos = jnp.where(sel, pdir, pdf_pos)       # -> pdf_fwd slot
            pdf_dir = jnp.where(sel, jnp.broadcast_to(disk_pdf, shape),
                                pdf_dir)                  # -> step density
            delta = delta | (sel & is_delta)
            infinite = infinite | sel
            alive = alive | sel
        elif t == em.EM_AREA:
            p_s, n_s, pdf_a = em._sample_area_position(emt, scene.geom, eid,
                                                       u_pos, eb)
            d_loc = warp.square_to_cosine_hemisphere(u_dir)
            fr = m.Frame.from_normal(n_s)
            d_s = m.Frame.to_world(fr, d_loc)
            pdir = jnp.maximum(d_loc[..., 2], 0.0) / jnp.pi
            msk = sel[..., None]
            p = jnp.where(msk, p_s, p)
            n = jnp.where(msk, n_s, n)
            d = jnp.where(msk, d_s, d)
            le = jnp.where(msk, eb["radiance"], le)
            pdf_pos = jnp.where(sel, pdf_a, pdf_pos)
            pdf_dir = jnp.where(sel, pdir, pdf_dir)
            alive = alive | sel
        elif t in (em.EM_POINT, em.EM_SPOT):
            d_s = warp.square_to_uniform_sphere(u_dir)
            inten = eb["intensity"]
            if t == em.EM_SPOT:
                cd = m.dot(d_s, eb["direction"])
                cc, cf = eb["cos_cutoff"], eb["cos_falloff"]
                fall = jnp.clip((cd - cc) / jnp.maximum(cf - cc, 1e-6), 0.0, 1.0)
                inten = inten * jnp.where(cd > cc, fall, 0.0)[..., None]
            msk = sel[..., None]
            p = jnp.where(msk, jnp.broadcast_to(eb["position"], p.shape), p)
            n = jnp.where(msk, d_s, n)
            d = jnp.where(msk, d_s, d)
            le = jnp.where(msk, inten, le)
            pdf_pos = jnp.where(sel, 1.0, pdf_pos)
            pdf_dir = jnp.where(sel, 1.0 / (4.0 * jnp.pi), pdf_dir)
            delta = delta | sel
            alive = alive | sel
        # collimated: measure-zero beam, lane stays dead

    return dict(
        p=p, ns=n, d=d, le=le, sel_pmf=sel_pmf, pdf_pos=pdf_pos,
        pdf_dir=pdf_dir, pdf_fwd=sel_pmf * pdf_pos, delta=delta,
        valid=alive, emitter=eid, infinite=infinite,
        pdf_rev=jnp.zeros(shape, Float),
    )


def pdf_light_origin(scene: Scene, emitter_id, valid_emitter):
    """Area density of sampling a given emitter point as a light origin:
    select pmf x position pdf.  Zero for non-area emitters (they cannot be
    hit by chance) — used for the s=0 vs s>=1 MIS terms."""
    emt = scene.emitters
    pmf = jnp.where(
        emt.select.pmf.shape[0] == 1, 1.0, emt.select.pmf[
            jnp.clip(emitter_id, 0, emt.select.pmf.shape[0] - 1)]
    )
    area = emt.total_area[jnp.clip(emitter_id, 0, emt.total_area.shape[0] - 1)]
    is_area = emt.type[jnp.clip(emitter_id, 0, emt.type.shape[0] - 1)] == em.EM_AREA
    ok = valid_emitter & is_area & (area > 0)
    return jnp.where(ok, pmf / jnp.maximum(area, 1e-20), 0.0)


def pdf_light_dir_area(scene: Scene, emitter_id, p_light, n_light, p_next,
                       n_next, valid, to_is_med=None, seg_mid=None):
    """Area/volume density at ``p_next`` of the light emitting toward it
    (cosine-hemisphere emission for area lights, uniform sphere for
    point/spot); medium-aware conversion when the target is a volume
    vertex or the segment crosses a scattering medium."""
    emt = scene.emitters
    eid = jnp.clip(emitter_id, 0, emt.type.shape[0] - 1)
    etype = emt.type[eid]
    d = _dir(p_light, p_next)
    cos_l = m.dot(n_light, d)
    pdf_sa_area = jnp.maximum(cos_l, 0.0) / jnp.pi
    pdf_sa_point = jnp.full(cos_l.shape, 1.0 / (4.0 * jnp.pi), Float)
    pdf_sa = jnp.where(etype == em.EM_AREA, pdf_sa_area,
                       jnp.where((etype == em.EM_POINT) | (etype == em.EM_SPOT),
                                 pdf_sa_point, 0.0))
    if to_is_med is None:
        return jnp.where(valid, _to_area(pdf_sa, p_light, p_next, n_next),
                         0.0)
    return jnp.where(valid, _conv_density(
        scene, pdf_sa, p_light, p_next, n_next, to_is_med, seg_mid, True),
        0.0)


def camera_pdf_dir(scene: Scene, d_world):
    """Solid-angle density of the camera sampling direction ``d_world``
    under uniform film-position sampling: 1 / (A_img cos^3 theta)."""
    sensor = scene.sensor
    d_cam = m.normalize(
        jnp.einsum("ij,...j->...i", sensor.to_camera[:3, :3], d_world,
                   precision=jax.lax.Precision.HIGHEST))
    cos_t = jnp.maximum(d_cam[..., 2], 1e-6)
    a_img = 4.0 * sensor.tan_x * sensor.tan_y
    return 1.0 / (a_img * cos_t ** 3)


# ---------------------------------------------------------------------------
# MIS weight
# ---------------------------------------------------------------------------

def mis_weight(scene: Scene, light_vs, eye_vs, s, t, overrides):
    """Balance-heuristic weight for strategy (s, t), PBRT-style.

    ``light_vs``/``eye_vs``: vertex dicts indexed 0..s-1 / 0..t-1 where
    eye_vs[0] is the camera record {p, pdf (unused)} and light_vs[0] is the
    origin record.  ``overrides`` maps (side, index) -> pdf_rev replacement
    arrays computed for the connection.  All indices are static.
    """
    if s + t == 2:
        return jnp.ones(eye_vs[0]["p"].shape[:-1], Float)

    def rev(side, i, default):
        return overrides.get((side, i), default)

    sum_ri = 0.0
    # eye side: hypothetical strategies moving the connection one eye
    # vertex earlier at a time
    ri = 1.0
    for i in range(t - 1, 0, -1):
        v = eye_vs[i]
        ri = ri * _remap0(rev("eye", i, v["pdf_rev"])) / _remap0(v["pdf_fwd"])
        d_i = v["delta"] if i >= 1 and "delta" in v else jnp.zeros_like(v["pdf_fwd"], dtype=bool)
        d_im1 = (eye_vs[i - 1]["delta"] if (i - 1) >= 1 else
                 jnp.zeros_like(d_i))  # camera vertex: not delta
        sum_ri = sum_ri + jnp.where(~d_i & ~d_im1, ri, 0.0)
    # light side
    ri = 1.0
    for i in range(s - 1, -1, -1):
        v = light_vs[i]
        ri = ri * _remap0(rev("light", i, v["pdf_rev"])) / _remap0(v["pdf_fwd"])
        d_i = v["delta"]
        d_im1 = light_vs[i - 1]["delta"] if i >= 1 else light_vs[0]["delta"]
        if i == 0:
            d_im1 = jnp.zeros_like(d_i)  # no vertex before the origin
        sum_ri = sum_ri + jnp.where(~d_i & ~d_im1, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)

# ---------------------------------------------------------------------------
# Strategy evaluation
# ---------------------------------------------------------------------------

def _medium_transition(scene, shape_id, d_world, ng, cur_mid):
    """New medium id after crossing a surface along d_world
    (array-API twin of volpath's _medium_transition_v)."""
    from ..core.types import INVALID

    sid = jnp.where(shape_id == INVALID, 0, shape_id)
    interior = scene.shape_interior[sid]
    exterior = scene.shape_exterior[sid]
    entering = m.dot(d_world, ng) < 0
    new = jnp.where(entering, interior, exterior)
    has = (interior != INVALID) | (exterior != INVALID)
    return jnp.where((shape_id != INVALID) & has, new, cur_mid)


def _seg_tr(scene, mid, o, d, dist, med_s):
    """Medium-aware edge transmittance (the ``PathEdge`` analog,
    ``/root/reference/include/mitsuba/bidir/edge.h:32-76``): full
    Beer-Lambert along a segment of length ``dist`` in per-lane medium
    ``mid`` (vacuum for INVALID); heterogeneous grid lanes are
    ratio-tracked (unbiased) with the dedicated ``med_s`` counter stream
    so connection transmittance never consumes primary-sample-table
    dimensions.  Returns (tr (N, 3), med_s)."""
    from ..media import medium as med

    _ss, st, _pt, _g = med.medium_params(scene.media, mid)
    tr = med.transmittance(st, dist)
    if scene.media.has_hetero:
        rows = med.hetero_rows(scene.media, mid)
        med_s, T = med.track_transmittance(
            scene.media, rows, o, d, dist, med_s, rows["is_het"])
        tr = jnp.where(rows["is_het"][..., None], T[..., None], tr)
    return tr, med_s


def _occluded_seg(scene, a, b):
    d2 = _dist2(a, b)
    dist = jnp.sqrt(jnp.maximum(d2, 1e-20))
    d = (b - a) / dist[..., None]
    return scene.occluded(a, d, EPSILON, dist * (1.0 - SHADOW_EPSILON)), d, dist


def bdpt_sample(scene: Scene, sampler, o_cam, d_cam, max_depth: int,
                hide_emitters: bool = False):
    """Evaluate every BDPT strategy for a wavefront of camera samples.

    Returns (li (N,3) same-pixel radiance, splat_uv (K,N,2),
    splat_val (K,N,3)) with K = number of t=1 strategies.
    """
    n = o_cam.shape[0]
    s = sampler

    # ambient medium for subpath origins (camera and lights both sit in
    # the scene's ambient medium; interior media are entered by crossing
    # their bounding shapes during the walk)
    has_media = scene.media.any
    medium0 = (jnp.full((n,), scene.camera_medium, Int)
               if has_media else None)
    # dedicated counter stream for ratio-tracked edge transmittance
    # (variable-draw: must never consume primary-sample-table dims)
    med_s = (mrng.make_sampler(s.pixel, s.sample,
                               s.seed ^ U32(0xA5D1C0DE))
             if has_media else None)

    # --- eye subpath -------------------------------------------------------
    cam_v = dict(p=o_cam, pdf_fwd=jnp.ones((n,), Float),
                 pdf_rev=jnp.zeros((n,), Float))
    pdf_cam = camera_pdf_dir(scene, d_cam)
    eye_vs, s, esc, _cam_rev = random_walk(
        scene, s, o_cam, d_cam, jnp.ones((n, 3), Float), pdf_cam,
        max_depth, o_cam, d_cam, medium0=medium0)
    # primary-escape marker for env weighting
    esc_primary = esc["escaped"] & ~eye_vs[0]["valid"] if eye_vs else esc["escaped"]

    # --- light subpath -----------------------------------------------------
    s, lblk = mrng.next_block4(s)
    s, lblk2 = mrng.next_block4(s)
    lv0 = sample_light_origin(scene, lblk[..., 0], lblk[..., 1:3],
                              lblk2[..., 0:2])
    cos0 = jnp.where(lv0["delta"], 1.0,
                     jnp.abs(m.dot(lv0["ns"], lv0["d"])))
    beta_l = lv0["le"] * (cos0 / jnp.maximum(
        lv0["pdf_fwd"] * lv0["pdf_dir"], 1e-20))[..., None]
    beta_l = jnp.where(lv0["valid"][..., None], beta_l, 0.0)
    light_tail, s, _lesc, l0_rev = random_walk(
        scene, s, lv0["p"], lv0["d"], beta_l, lv0["pdf_dir"],
        max(max_depth - 1, 0), lv0["p"], lv0["ns"], adjoint=True,
        infinite0=lv0["infinite"], medium0=medium0)
    lv0 = dict(lv0)
    lv0["pdf_rev"] = l0_rev
    lv0["mid"] = medium0
    lv0["is_med"] = jnp.zeros((n,), bool)
    lv0["wi_world"] = lv0["d"]
    light_vs = [lv0] + light_tail
    # a light vertex is usable only if the whole prefix is valid
    pref = lv0["valid"]
    for v in light_tail:
        pref = pref & v["valid"]
        v["valid"] = pref

    emt = scene.emitters
    li = jnp.zeros((n, 3), Float)
    splat_uvs, splat_vals = [], []

    T = len(eye_vs)        # eye surface vertices: index ti in [0, T)
    S = len(light_vs)      # light vertices incl. origin: index si in [0, S)

    # --- s=0: eye path hits an emitter ------------------------------------
    for ti in range(T):
        t_cnt = ti + 2  # camera + surfaces 0..ti
        v = eye_vs[ti]
        has_em = v["valid"] & (v["emitter"] >= 0)
        prev_p = o_cam if ti == 0 else eye_vs[ti - 1]["p"]
        wo = _dir(v["p"], prev_p)
        Le = em.emitted_radiance(emt, v["emitter"], v["ns"], wo)
        if ti == 0 and hide_emitters:
            continue
        overrides = {
            ("eye", ti + 1): pdf_light_origin(scene, v["emitter"], has_em),
        }
        if ti >= 1:
            pm = eye_vs[ti - 1]
            overrides[("eye", ti)] = pdf_light_dir_area(
                scene, v["emitter"], v["p"], v["ns"], pm["p"], pm["ns"],
                has_em,
                to_is_med=pm["is_med"] if has_media else None,
                seg_mid=v["mid"])
        # eye_vs shifted by 1: camera is index 0 in the MIS lists
        mis_eye = [cam_v] + eye_vs[: ti + 1]
        w = mis_weight(scene, [], mis_eye, 0, t_cnt, overrides)
        li = li + jnp.where(has_em[..., None], v["beta"] * Le * w[..., None],
                            0.0)

    # --- env escape: s=0 with the environment as a pseudo-vertex at
    # infinity, weighted uniformly against NEE-env AND the light-subpath
    # connection strategies (solid-angle measure at the infinite vertex)
    if emt.env_index >= 0 or em.EM_CONSTANT in emt.used_types:
        env_val = em.eval_environment(emt, esc["d"])
        env_pdf = em.pdf_direct_env(emt, esc["d"])
        r_w = emt.bsphere_radius * 1.05 + 1e-4
        disk_pdf = 1.0 / (jnp.pi * r_w * r_w)
        for ti in range(T + 1):
            mask = esc["escaped"] & (esc["i"] == ti)
            if ti == 0:
                # primary escape: only one strategy exists
                w = jnp.where(mask, 1.0, 0.0)
                if hide_emitters:
                    w = jnp.zeros_like(w)
                li = li + jnp.where(mask[..., None],
                                    esc["beta"] * env_val * w[..., None], 0.0)
                continue
            env_v = dict(
                p=eye_vs[ti - 1]["p"],  # placeholder (unused: ratios are SA)
                pdf_fwd=jnp.where(esc["delta"], 0.0, esc["pdf_dir"]),
                pdf_rev=env_pdf,  # direct env sampling density (SA)
                delta=esc["delta"], valid=mask,
            )
            prev = eye_vs[ti - 1]
            overrides = {
                # light-walk alternative lands on the previous eye vertex
                # with disk density x |cos|
                ("eye", ti): jnp.where(
                    mask, disk_pdf * jnp.abs(m.dot(prev["ns"], esc["d"])),
                    prev["pdf_rev"]),
            }
            mis_eye = [cam_v] + eye_vs[:ti] + [env_v]
            w = mis_weight(scene, [], mis_eye, 0, ti + 2, overrides)
            w = jnp.where(esc["delta"], 1.0, w)
            li = li + jnp.where(mask[..., None],
                                esc["beta"] * env_val * w[..., None], 0.0)

    # --- s=1: NEE from each eye vertex (surface or medium) ----------------
    for ti in range(T):
        if (ti + 1) + 1 > max_depth:  # edges = camera chain (ti+1) + 1
            break
        v = eye_vs[ti]
        s, blk = mrng.next_block4(s)
        ds = em.sample_direct(emt, scene.geom, v["p"], blk[..., 0],
                              blk[..., 1:3])
        f = _vertex_f(scene, v, ds.d, has_media)
        occ = scene.occluded(v["p"], ds.d, EPSILON,
                             ds.dist * (1.0 - SHADOW_EPSILON))
        ok = v["valid"] & (ds.pdf > 0) & ~occ
        contrib = v["beta"] * ds.value * f / jnp.maximum(ds.pdf, 1e-20)[..., None]
        if has_media:
            tr_e, med_s = _seg_tr(scene, v["mid"], v["p"], ds.d, ds.dist,
                                  med_s)
            contrib = contrib * tr_e

        q_p = v["p"] + ds.d * ds.dist[..., None]
        cos_q = jnp.abs(m.dot(ds.n, -ds.d))
        eid_c = jnp.clip(ds.emitter, 0, emt.type.shape[0] - 1)
        et_q = emt.type[eid_c]
        inf_q = ((et_q == em.EM_ENVMAP) | (et_q == em.EM_CONSTANT)
                 | (et_q == em.EM_DIRECTIONAL))
        q_fwd = jnp.where(ds.delta, ds.pdf,
                          ds.pdf * cos_q / jnp.maximum(ds.dist ** 2, 1e-20))
        # infinite emitters: keep the solid-angle measure at the pseudo
        # vertex (matches the light-origin convention)
        q_fwd = jnp.where(inf_q & ~ds.delta, ds.pdf, q_fwd)
        bsdf_rev_sa = _vertex_pdf(scene, v, ds.d, has_media)
        if has_media:
            q_rev = _conv_density(scene, bsdf_rev_sa, v["p"], q_p, ds.n,
                                  jnp.zeros((n,), bool), v["mid"], True)
        else:
            q_rev = _to_area(bsdf_rev_sa, v["p"], q_p, ds.n)
        q_rev = jnp.where(inf_q, bsdf_rev_sa, q_rev)
        q_v = dict(p=q_p, ns=ds.n, pdf_fwd=q_fwd, pdf_rev=q_rev,
                   delta=ds.delta, valid=ok, emitter=ds.emitter)
        r_w1 = emt.bsphere_radius * 1.05 + 1e-4
        disk_pdf1 = 1.0 / (jnp.pi * r_w1 * r_w1)
        overrides = {
            ("eye", ti + 1): jnp.where(
                inf_q, disk_pdf1 * jnp.abs(m.dot(v["ns"], ds.d)),
                pdf_light_dir_area(
                    scene, ds.emitter, q_p, ds.n, v["p"], v["ns"], ok,
                    to_is_med=v["is_med"] if has_media else None,
                    seg_mid=v["mid"])),
        }
        if ti >= 1:
            pm = eye_vs[ti - 1]
            rev_sa = _vertex_pdf(scene, v, ds.d, has_media, reverse=True)
            if has_media:
                overrides[("eye", ti)] = _conv_density(
                    scene, rev_sa, v["p"], pm["p"], pm["ns"], pm["is_med"],
                    pm["mid"], True)
            else:
                overrides[("eye", ti)] = _to_area(
                    rev_sa, v["p"], pm["p"], pm["ns"])
        mis_eye = [cam_v] + eye_vs[: ti + 1]
        w = mis_weight(scene, [q_v], mis_eye, 1, ti + 2, overrides)
        li = li + jnp.where(ok[..., None], contrib * w[..., None], 0.0)

    # --- t=1: light tracing to the camera ----------------------------------
    for si in range(1, S):
        if (si + 1) > max_depth:  # edges = si + 1
            break
        v = light_vs[si]
        uv, cam_p, dist, We, vis = sensor_connect(scene.sensor, v["p"])
        d_vc = _dir(v["p"], cam_p)
        f = _vertex_f(scene, v, d_vc, has_media, adjoint=True)
        occ = scene.occluded(v["p"], d_vc, EPSILON,
                             dist * (1.0 - SHADOW_EPSILON))
        ok = v["valid"] & vis & ~occ
        val = v["beta"] * f * (We / jnp.maximum(dist * dist, 1e-20))[..., None]
        if has_media:
            tr_e, med_s = _seg_tr(scene, v["mid"], v["p"], d_vc, dist,
                                  med_s)
            val = val * tr_e

        rev_sa = _vertex_pdf(scene, v, d_vc, has_media, reverse=True)
        pv_l = light_vs[si - 1]
        if has_media:
            rev_prev = _conv_density(
                scene, rev_sa, v["p"], pv_l["p"], pv_l["ns"],
                pv_l["is_med"], v["mid"], True)
            cam_conv = _conv_density(
                scene, camera_pdf_dir(scene, -d_vc), cam_p, v["p"],
                v["ns"], v["is_med"], v["mid"], True)
        else:
            rev_prev = _to_area(rev_sa, v["p"], pv_l["p"], pv_l["ns"])
            cam_conv = _to_area(camera_pdf_dir(scene, -d_vc), cam_p,
                                v["p"], v["ns"])
        if si - 1 == 0:
            rev_prev = jnp.where(lv0["infinite"], rev_sa, rev_prev)
        overrides = {
            ("light", si): cam_conv,
            ("light", si - 1): rev_prev,
        }
        w = mis_weight(scene, light_vs[: si + 1], [cam_v], si + 1, 1,
                       overrides)
        splat_uvs.append(uv)
        splat_vals.append(jnp.where(ok[..., None], val * w[..., None], 0.0))

    # --- s>=2, t>=1 inner connections (surface or medium endpoints) -------
    def _conv(pdf_sa, from_p, to_v, seg_mid):
        if has_media:
            return _conv_density(scene, pdf_sa, from_p, to_v["p"],
                                 to_v["ns"], to_v["is_med"], seg_mid, True)
        return _to_area(pdf_sa, from_p, to_v["p"], to_v["ns"])

    for si in range(1, S):
        for ti in range(T):
            if si + ti + 2 > max_depth:  # edges = (si+1) + (ti+2) - 1
                continue
            vq = light_vs[si]
            vp = eye_vs[ti]
            ok0 = vq["valid"] & vp["valid"]
            occ, d_pq, dist = _occluded_seg(scene, vp["p"], vq["p"])
            f_p = _vertex_f(scene, vp, d_pq, has_media)
            f_q = _vertex_f(scene, vq, -d_pq, has_media, adjoint=True)
            ok = ok0 & ~occ
            contrib = vp["beta"] * vq["beta"] * f_p * f_q / \
                jnp.maximum(dist * dist, 1e-20)[..., None]
            if has_media:
                tr_e, med_s = _seg_tr(scene, vp["mid"], vp["p"], d_pq,
                                      dist, med_s)
                contrib = contrib * tr_e

            rev_q_sa = _vertex_pdf(scene, vq, -d_pq, has_media,
                                   reverse=True)
            rev_prev_q = _conv(rev_q_sa, vq["p"], light_vs[si - 1],
                               vq["mid"] if has_media else None)
            if si - 1 == 0:
                rev_prev_q = jnp.where(lv0["infinite"], rev_q_sa,
                                       rev_prev_q)
            overrides = {
                ("eye", ti + 1): _conv(
                    _vertex_pdf(scene, vq, -d_pq, has_media), vq["p"], vp,
                    vp["mid"] if has_media else None),
                ("light", si): _conv(
                    _vertex_pdf(scene, vp, d_pq, has_media), vp["p"], vq,
                    vp["mid"] if has_media else None),
                ("light", si - 1): rev_prev_q,
            }
            if ti >= 1:
                pm = eye_vs[ti - 1]
                overrides[("eye", ti)] = _conv(
                    _vertex_pdf(scene, vp, d_pq, has_media, reverse=True),
                    vp["p"], pm, pm["mid"] if has_media else None)
            mis_eye = [cam_v] + eye_vs[: ti + 1]
            w = mis_weight(scene, light_vs[: si + 1], mis_eye, si + 1,
                           ti + 2, overrides)
            li = li + jnp.where(ok[..., None], contrib * w[..., None], 0.0)

    if splat_uvs:
        return li, jnp.stack(splat_uvs), jnp.stack(splat_vals)
    return li, jnp.zeros((0, n, 2), Float), jnp.zeros((0, n, 3), Float)


# ---------------------------------------------------------------------------
# Render loop
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "max_depth", "hide_emitters",
                     "light_image"),
    donate_argnames=("film_data", "light_img"),
)
def bdpt_pass(scene: Scene, film_data, light_img, sample_idx, seed, *,
              width, height, max_depth, hide_emitters, light_image):
    n = width * height
    pix = jnp.arange(n, dtype=U32)
    sampler = mrng.make_sampler(pix, sample_idx, seed)
    sampler, blk0 = mrng.next_block4(sampler)
    jitter, u_lens = blk0[..., :2], blk0[..., 2:4]
    px = (pix % width).astype(Float)
    py = (pix // width).astype(Float)
    pos = jnp.stack([px, py], axis=-1) + jitter
    uv = pos / jnp.asarray([width, height], Float)
    o, d, _w = sample_ray(scene.sensor, uv, u_lens)

    li, s_uv, s_val = bdpt_sample(scene, sampler, o, d, max_depth,
                                  hide_emitters)
    li = jnp.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0)

    film = Film(data=film_data, width=width, height=height, ftype=0,
                radius=0.5)
    film = film_splat(film, pos, li)

    if light_image and s_uv.shape[0] > 0:
        sp = s_uv.reshape(-1, 2) * jnp.asarray([width, height], Float)
        sv = jnp.nan_to_num(s_val.reshape(-1, 3), nan=0.0, posinf=0.0,
                            neginf=0.0)
        sx = jnp.clip(sp[..., 0].astype(Int), 0, width - 1)
        sy = jnp.clip(sp[..., 1].astype(Int), 0, height - 1)
        light_img = light_img.reshape(-1, 3).at[sy * width + sx].add(
            sv, mode="drop").reshape(height, width, 3)
    return film.data, light_img


def render_bdpt(scene: Scene, settings, spp: int | None = None,
                progress_cb=None) -> np.ndarray:
    ip = settings.integrator_props
    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    md = ip.get("max_depth", -1)
    max_depth = md if md > 0 else 6
    hide = bool(ip.get("hide_emitters", False))
    light_image = bool(ip.get("light_image", True))

    film_data = jnp.zeros((H, W, 4), Float)
    light_img = jnp.zeros((H, W, 3), Float)
    seed = jnp.uint32(settings.seed)
    for si in range(spp):
        film_data, light_img = bdpt_pass(
            scene, film_data, light_img, jnp.uint32(si), seed,
            width=W, height=H, max_depth=max_depth, hide_emitters=hide,
            light_image=light_image)
        if progress_cb is not None:
            progress_cb(si + 1, spp, film_data)

    w = np.asarray(film_data[..., 3:4])
    base = np.where(w > 0, np.asarray(film_data[..., :3]) / np.maximum(w, 1e-12), 0.0)
    # light image: one light subpath per pixel-lane per pass
    return (base + np.asarray(light_img) / spp).astype(np.float32)
