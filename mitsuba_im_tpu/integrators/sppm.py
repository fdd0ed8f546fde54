"""Stochastic progressive photon mapping (+ ppm / photonmapper dispatch).

Parity targets: ``/root/reference/src/integrators/photonmapper/{sppm,ppm,
photonmapper}.cpp`` — progressive photon mapping with per-pixel shrinking
gather radii (Hachisuka & Jensen 2009), built on the particle-tracing
infrastructure (``include/mitsuba/render/particleproc.h:45``) and the
balanced point-kd photon map (``photonmap.h:34``).

Wavefront redesign (SURVEY.md §2.7 "particle/photon parallelism"): the
CPU kd-tree photon map becomes a **sort-based spatial hash grid** —

  1. photon pass: a flat wavefront of light subpaths deposits photons at
     every surface vertex (SoA arrays, one slot per (particle, bounce));
  2. grid build: quantize positions to cells of size = max gather radius,
     hash cell coords into 2^b buckets, ``argsort`` photons by bucket, and
     locate bucket runs with ``searchsorted`` — an O(M log M) fully
     data-parallel build, no pointers;
  3. gather: every eye vertex scans the 27 neighbor cells; each cell's run
     is walked with a static-bound loop (cap P photons/cell), distances and
     BSDF response evaluated vectorized over all pixels at once.

Eye pass: camera rays walk through delta (specular/null) bounces up to a
static budget and stop at the first smooth vertex (the reference gathers at
diffuse surfaces and recurses through specular chains); emitted radiance
seen along the specular chain accumulates directly.

Per-pixel SPPM statistics follow Hachisuka's update: with alpha in (0,1),
N' = N + alpha*M, R'^2 = R^2 * N'/(N+M), tau' = (tau + sum f*phi) * R'^2/R^2,
and the final estimate is L = tau / (n_passes * pi * R^2) + L_direct/n_passes.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import Float, Int, EPSILON
from ..core import math as m
from ..core import rng as mrng
from ..bsdf.eval import bsdf_eval, bsdf_sample
from ..bsdf.common import lane_is_delta
from ..scene.scene import Scene
from ..sensor.table import sample_ray
from .path import PathConfig, _fake_it
from .ptracer import sample_emitter_ray

U32 = jnp.uint32
HASH_BITS = 18  # 262144 buckets


def _cell_hash(c: jax.Array) -> jax.Array:
    """3D integer cell -> hash bucket (public-domain 3-word mix).

    Buckets span [0, 2^HASH_BITS - 2]; the top value is reserved as the
    invalid-photon sentinel."""
    x = c[..., 0].astype(U32) * U32(73856093)
    y = c[..., 1].astype(U32) * U32(19349663)
    z = c[..., 2].astype(U32) * U32(83492791)
    return (x ^ y ^ z) % U32((1 << HASH_BITS) - 1)


def photon_trace(scene: Scene, sampler, n_particles: int, max_bounces: int,
                 rr_depth: int = 5, want_surface: bool = False,
                 want_volume: bool = False):
    """Trace light paths, depositing a photon at every scattering event.

    Returns SoA photon arrays of length n_particles * max_bounces:
    (p (M,3), power (M,3), wi_world (M,3) — direction toward the light,
    valid (M,)).  Powers are per emitted path (caller divides by
    n_particles).  With ``want_surface`` also returns a dict of surface
    fields (ns/ss/ts/uv/shape/wi_local) so the deposits can serve as
    virtual point lights (the VPL integrator's generateVPLs analog,
    ``src/librender/vpl.cpp``).

    With ``want_volume`` (scenes with scattering media) each step also
    races a free-flight distance against the surface hit and deposits
    **volume photons** at medium scattering events — the storage half of
    the beam radiance estimate (``photonmapper/bre.cpp`` +
    ``particleproc.h:128-226`` ``handleMediumInteraction``).  Volume
    photon power is the arriving flux with the free-flight weight but
    WITHOUT sigma_s (the gather multiplies sigma_s x phase), so the beam
    estimator integrates exactly the in-scattered source term.  Returns
    an extra tuple (vp (M,3), vpow (M,3), vwi (M,3), vvalid (M,)).
    """
    from ..media import medium as med
    from .bdpt import _medium_transition, _seg_sigma

    has_vol = want_volume and scene.media.any
    s = sampler
    s, blk = mrng.next_block4(s)
    s, blk2 = mrng.next_block4(s)
    ls = sample_emitter_ray(scene, blk[..., 0], blk[..., 1:3], blk2[..., 0:2])
    n = ls.p.shape[0]

    ps, powers, wis, valids = [], [], [], []
    vps, vpows, vwis, vvalids = [], [], [], []
    surf = {k: [] for k in ("ns", "ss", "ts", "uv", "shape", "wi_local")}

    prev_p = ls.p
    cur_d = ls.d
    thr = ls.weight
    alive = jnp.ones((n,), bool)
    mid = (jnp.full((n,), scene.camera_medium, Int)
           if has_vol else None)

    for depth in range(1, max_bounces + 1):
        hit = scene.ray_intersect(prev_p, cur_d)
        it = scene.interaction(prev_p, cur_d, hit)

        if has_vol:
            s, mblk = mrng.next_block4(s)
            ss_m, st_m, pt_m, g_m = med.medium_params(scene.media, mid)
            sbar = _seg_sigma(scene, mid)
            t_m = jnp.where(
                sbar > 0,
                -jnp.log(jnp.maximum(1.0 - mblk[..., 0], 1e-20))
                / jnp.maximum(sbar, 1e-20), 3e37)
            t_surf = jnp.where(it.valid, hit.t, 3e37)
            in_scat = alive & (sbar > 0) & (t_m < t_surf)
            t_fin = jnp.where(in_scat, t_m, t_surf)
            tr_full = med.transmittance(st_m, jnp.minimum(t_fin, 1e30))
            pdf_t = jnp.maximum(sbar, 1e-20) * jnp.exp(-sbar * t_m)
            p_srf = jnp.maximum(jnp.exp(
                -sbar * jnp.minimum(t_surf, 1e30)), 1e-20)
            # volume deposit: flux arriving at the event (no sigma_s)
            phi_v = thr * tr_full / pdf_t[..., None]
            p_med = prev_p + cur_d * jnp.where(in_scat, t_m, 0.0)[..., None]
            vps.append(p_med)
            vpows.append(jnp.where(in_scat[..., None], phi_v, 0.0))
            vwis.append(-cur_d)
            vvalids.append(in_scat)
            # surviving-to-surface lanes reweight; scattering lanes pick
            # up sigma_s and a phase-sampled continuation
            w_med = tr_full * (ss_m / pdf_t[..., None])
            w_srf = tr_full / p_srf[..., None]
            thr = thr * jnp.where(in_scat[..., None], w_med, w_srf)
            surf_ok = alive & it.valid & ~in_scat
        else:
            in_scat = jnp.zeros((n,), bool)
            surf_ok = alive & it.valid

        bparams = scene.bsdf_at(_fake_it(dict(
            p=it.p, ng=it.ng, ns=it.ns, ss=it.ss, ts=it.ts_, uv=it.uv,
            wi_local=it.wi_local, shape=it.shape, active=surf_ok)))
        # deposit at smooth surface vertices (delta surfaces store no flux)
        smooth = surf_ok & ~lane_is_delta(bparams)
        ps.append(it.p)
        powers.append(jnp.where(smooth[..., None], thr, 0.0))
        wis.append(-cur_d)
        valids.append(smooth)
        if want_surface:
            for k in ("ns", "ss", "uv", "shape", "wi_local"):
                surf[k].append(getattr(it, k if k != "ts" else "ts_"))
            surf["ts"].append(it.ts_)

        s, bsdf_blk = mrng.next_block4(s)
        bs = bsdf_sample(bparams, it.wi_local, bsdf_blk[..., 0],
                         bsdf_blk[..., 1:3], bsdf_blk[..., 3])
        frame = (it.ss, it.ts_, it.ns)
        wo_surf = m.Frame.to_world(frame, bs.wo)
        if has_vol:
            wo_ph, _pdf_ph = med.phase_sample(pt_m, g_m, -cur_d,
                                              mblk[..., 1:3])
            wo_world = jnp.where(in_scat[..., None], wo_ph, wo_surf)
            w_step = jnp.where(in_scat[..., None], 1.0, bs.weight)
            next_p = jnp.where(in_scat[..., None], p_med, it.p)
        else:
            wo_world = wo_surf
            w_step = bs.weight
            next_p = it.p
        thr = thr * jnp.where(in_scat[..., None], 1.0, w_step)
        act = (surf_ok | in_scat) & (jnp.sum(thr, axis=-1) > 0)

        s, rr_blk = mrng.next_block4(s)
        q = jnp.minimum(jnp.max(thr, axis=-1), 0.95)
        do_rr = depth >= rr_depth
        kill = do_rr & (rr_blk[..., 0] >= q)
        thr = jnp.where((do_rr & ~kill)[..., None],
                        thr / jnp.maximum(q, 1e-6)[..., None], thr)
        alive = act & ~kill
        if has_vol:
            mid = jnp.where(
                surf_ok, _medium_transition(scene, it.shape, wo_world,
                                            it.ng, mid), mid)
        prev_p = next_p
        cur_d = wo_world

    base = (jnp.concatenate(ps), jnp.concatenate(powers),
            jnp.concatenate(wis), jnp.concatenate(valids))
    if want_surface:
        base = base + ({k: jnp.concatenate(v) for k, v in surf.items()},)
    if want_volume:
        if has_vol:
            vol = (jnp.concatenate(vps), jnp.concatenate(vpows),
                   jnp.concatenate(vwis), jnp.concatenate(vvalids))
        else:
            z = jnp.zeros((1, 3), Float)
            vol = (z, z, z, jnp.zeros((1,), bool))
        base = base + (vol,)
    return base


def build_grid(p: jax.Array, valid: jax.Array, cell: jax.Array):
    """Sort-based photon hash grid.

    Returns (order (M,), bucket_sorted (M,)): photon indices sorted by hash
    bucket and the sorted bucket ids (invalid photons sort to bucket MAX so
    they never match a query).
    """
    c = jnp.floor(p / cell).astype(jnp.int32)
    b = _cell_hash(c)
    b = jnp.where(valid, b, U32((1 << HASH_BITS) - 1))
    # randomize within-bucket order (low 12 key bits) so a capped prefix
    # scan is a *uniform* subsample of the cell — a stable sort would put
    # early bounces first, biasing the overflow correction
    M = b.shape[0]
    r12 = mrng.hash_u32(jnp.arange(M, dtype=U32), b) & U32(0xFFF)
    key = (b << U32(12)) | r12
    order = jnp.argsort(key)
    return order, b[order]


def gather(p_photon, power, wi_photon, order, bucket_sorted, x, frame_ss,
           frame_ts, frame_ns, wi_local_eye, bparams, r2, cell,
           cap: int):
    """Density estimate at eye vertices x: sum f(wi_eye, wo_photon) * phi
    over photons within sqrt(r2), scanning 27 neighbor cells (cap per cell)."""
    n = x.shape[0]
    acc = jnp.zeros((n, 3), Float)
    cnt = jnp.zeros((n,), Float)
    base = jnp.floor(x / cell).astype(jnp.int32)
    M = bucket_sorted.shape[0]

    # all 27 neighbor-cell runs up front: starts/runs are (27, n)
    offs = jnp.asarray(
        [[dx, dy, dz] for dz in (-1, 0, 1) for dy in (-1, 0, 1)
         for dx in (-1, 0, 1)], jnp.int32)
    cc = base[None, :, :] + offs[:, None, :]
    b = _cell_hash(cc)
    starts = jnp.searchsorted(bucket_sorted, b, side="left")
    ends = jnp.searchsorted(bucket_sorted, b, side="right")
    fulls = ends - starts
    runs = jnp.minimum(fulls, cap)

    def body(j, carry):
        acc, cnt = carry
        ci = j // cap
        k = j % cap
        start = jax.lax.dynamic_index_in_dim(starts, ci, 0, keepdims=False)
        run = jax.lax.dynamic_index_in_dim(runs, ci, 0, keepdims=False)
        full = jax.lax.dynamic_index_in_dim(fulls, ci, 0, keepdims=False)
        idx = jnp.minimum(start + k, M - 1)
        pid = order[idx]
        ok = k < run
        # cell-overflow correction: when a cell run exceeds the scan cap we
        # uniformly subsample it; upweight by full/scanned to stay unbiased
        over = (full.astype(Float) / jnp.maximum(run.astype(Float), 1.0))
        d = x - p_photon[pid]
        d2 = jnp.sum(d * d, axis=-1)
        ok = ok & (d2 <= r2)
        wo_world = wi_photon[pid]
        wo_local = jnp.stack([
            jnp.sum(frame_ss * wo_world, -1),
            jnp.sum(frame_ts * wo_world, -1),
            jnp.sum(frame_ns * wo_world, -1),
        ], axis=-1)
        f = bsdf_eval(bparams, wi_local_eye, wo_local)
        # bsdf_eval folds in |cos(wo)|; density estimation wants the raw
        # BSDF response, so divide the cosine back out
        cos_o = jnp.abs(wo_local[..., 2])
        f = f / jnp.maximum(cos_o, 1e-6)[..., None]
        contrib = f * power[pid] * over[..., None]
        acc = acc + jnp.where(ok[..., None], contrib, 0.0)
        cnt = cnt + jnp.where(ok, over, 0.0)
        return acc, cnt

    acc, cnt = jax.lax.fori_loop(0, 27 * cap, body, (acc, cnt))
    return acc, cnt


def beam_gather(scene, vp, vpow, vwi, order_v, bsorted_v, o, d, t_seg, mid,
                cell_v, cap: int, n_steps: int, u_jit):
    """Beam radiance estimate along camera segments (bre.cpp analog).

    Stratified-jittered quadrature of the beam integral
    L = int_0^T Tr(t) sigma_s(x_t) sum_j phase_j Phi_j K3(x_t - x_j) dt:
    ``n_steps`` sample points per ray per pass (unbiased in expectation
    over the per-pass jitter w.r.t. the kernel field), each gathering the
    27-neighborhood of the volume-photon hash grid with a 3D Epanechnikov
    kernel.  Homogeneous media (heterogeneous beams are carried by
    volpath; documented).
    """
    from ..media import medium as med

    n = o.shape[0]
    ss_m, st_m, pt_m, g_m = med.medium_params(scene.media, mid)
    in_med = jnp.mean(ss_m, -1) > 0
    T = jnp.where(in_med, jnp.minimum(t_seg, 1e4), 0.0)
    dt = T / n_steps
    r2v = cell_v * cell_v
    M = bsorted_v.shape[0]
    offs = jnp.asarray(
        [[dx, dy, dz] for dz in (-1, 0, 1) for dy in (-1, 0, 1)
         for dx in (-1, 0, 1)], jnp.int32)

    acc = jnp.zeros((n, 3), Float)
    for k in range(n_steps):
        t_k = (k + u_jit) * dt
        x = o + d * t_k[..., None]
        tr_k = med.transmittance(st_m, t_k)
        base = jnp.floor(x / cell_v).astype(jnp.int32)
        cc = base[None, :, :] + offs[:, None, :]
        b = _cell_hash(cc)
        starts = jnp.searchsorted(bsorted_v, b, side="left")
        ends = jnp.searchsorted(bsorted_v, b, side="right")
        fulls = ends - starts
        runs = jnp.minimum(fulls, cap)

        def body(j, a):
            ci = j // cap
            kk = j % cap
            start = jax.lax.dynamic_index_in_dim(starts, ci, 0,
                                                 keepdims=False)
            run = jax.lax.dynamic_index_in_dim(runs, ci, 0, keepdims=False)
            full = jax.lax.dynamic_index_in_dim(fulls, ci, 0,
                                                keepdims=False)
            idx = jnp.minimum(start + kk, M - 1)
            pid = order_v[idx]
            ok = kk < run
            over = (full.astype(Float)
                    / jnp.maximum(run.astype(Float), 1.0))
            dd = x - vp[pid]
            d2 = jnp.sum(dd * dd, axis=-1)
            ok = ok & (d2 <= r2v)
            # 3D Epanechnikov kernel (normalized over the ball)
            kern = (15.0 / (8.0 * jnp.pi * r2v * cell_v)) \
                * (1.0 - d2 / jnp.maximum(r2v, 1e-20))
            ph = med.phase_eval(pt_m, g_m, vwi[pid], -d)
            contrib = vpow[pid] * (ph * kern * over)[..., None]
            return a + jnp.where(ok[..., None], contrib, 0.0)

        s_k = jax.lax.fori_loop(0, 27 * cap, body, jnp.zeros((n, 3), Float))
        acc = acc + tr_k * ss_m * s_k * dt[..., None]
    return acc


def eye_pass(scene: Scene, sampler, width, height, max_delta_bounces: int):
    """Camera rays -> first smooth vertex (walking through delta chains).

    Returns (pos_px (N,2), gather point fields, throughput, L_emitted)."""
    n = width * height
    pix = jnp.arange(n, dtype=U32)
    s = sampler
    s, blk0 = mrng.next_block4(s)
    jitter = blk0[..., :2]
    px = (pix % width).astype(Float)
    py = (pix // width).astype(Float)
    pos = jnp.stack([px, py], axis=-1) + jitter
    uv = pos / jnp.asarray([width, height], Float)
    o, d, w_sensor = sample_ray(scene.sensor, uv, blk0[..., 2:4])

    from ..emitter import table as em

    thr = jnp.ones((n, 3), Float) * w_sensor[..., None]
    le = jnp.zeros((n, 3), Float)

    hit = scene.ray_intersect(o, d)
    it = scene.interaction(o, d, hit)
    esc = ~it.valid
    bsr = scene.emitters.bsphere_radius
    t_seg = jnp.where(it.valid, hit.t, 2.2 * bsr)
    prim = dict(o=o, d=d, t=t_seg)
    if scene.media.any:
        # primary-segment transmittance (delta-chain segments through
        # media are carried by volpath; documented approximation)
        from ..media import medium as med

        mid0 = jnp.full((n,), scene.camera_medium, Int)
        _ss, st_m, _pt, _g = med.medium_params(scene.media, mid0)
        thr = thr * med.transmittance(st_m, t_seg)
        prim["mid"] = mid0
    le = le + jnp.where(esc[..., None], thr * em.eval_environment(scene.emitters, d), 0.0)
    eid = scene.emitter_at(it)
    le = le + jnp.where(it.valid[..., None],
                        thr * em.emitted_radiance(scene.emitters, eid, it.ns, -d), 0.0)

    state = dict(
        thr=thr, active=it.valid, le=le, settled=jnp.zeros((n,), bool),
        p=it.p, ns=it.ns, ng=it.ng, ss=it.ss, ts=it.ts_, uv=it.uv,
        shape=it.shape, wi_local=it.wi_local, d_world=d, sampler=s,
    )

    for _ in range(max_delta_bounces):
        st = state
        bparams = scene.bsdf_at(_fake_it(st))
        is_delta = lane_is_delta(bparams)
        settle_now = st["active"] & ~st["settled"] & ~is_delta
        settled = st["settled"] | settle_now
        walk = st["active"] & ~settled

        s = st["sampler"]
        s, bsdf_blk = mrng.next_block4(s)
        bs = bsdf_sample(bparams, st["wi_local"], bsdf_blk[..., 0],
                         bsdf_blk[..., 1:3], bsdf_blk[..., 3])
        frame = (st["ss"], st["ts"], st["ns"])
        wo_world = m.Frame.to_world(frame, bs.wo)
        thr2 = st["thr"] * bs.weight
        hit2 = scene.ray_intersect(st["p"], wo_world)
        it2 = scene.interaction(st["p"], wo_world, hit2)

        eid2 = scene.emitter_at(it2)
        le2 = em.emitted_radiance(scene.emitters, eid2, it2.ns, -wo_world)
        env2 = em.eval_environment(scene.emitters, wo_world)
        hitval = jnp.where(it2.valid[..., None], le2, env2)
        le_new = st["le"] + jnp.where(walk[..., None], thr2 * hitval, 0.0)

        act2 = walk & it2.valid & (jnp.sum(thr2, axis=-1) > 0)
        # keep settled lanes frozen; only walking lanes advance
        def pick(new, old, extra_dim=True):
            mask = walk[..., None] if extra_dim else walk
            return jnp.where(mask, new, old)

        state = dict(
            thr=pick(thr2, st["thr"]),
            active=jnp.where(walk, act2, st["active"]),
            le=le_new, settled=settled,
            p=pick(it2.p, st["p"]), ns=pick(it2.ns, st["ns"]),
            ng=pick(it2.ng, st["ng"]), ss=pick(it2.ss, st["ss"]),
            ts=pick(it2.ts_, st["ts"]), uv=pick(it2.uv, st["uv"]),
            shape=pick(it2.shape, st["shape"], False),
            wi_local=pick(it2.wi_local, st["wi_local"]),
            d_world=pick(wo_world, st["d_world"]), sampler=s,
        )

    st = state
    gatherable = st["settled"] & st["active"]
    return pos, st, gatherable, prim


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "n_photons", "max_bounces", "cap",
                     "alpha"),
    donate_argnames=("stats",),
)
def sppm_pass(scene: Scene, stats, pass_idx, seed, cell, *, width, height,
              n_photons, max_bounces, cap, alpha):
    """One SPPM iteration: eye pass + photon pass + statistics update.

    stats = dict(r2 (N,), n (N,), tau (N,3), ld (N,3)).
    """
    n = width * height
    pix = jnp.arange(n, dtype=U32)
    s_eye = mrng.make_sampler(pix, pass_idx, seed)
    pos, st, gatherable, prim = eye_pass(scene, s_eye, width, height,
                                         max_delta_bounces=6)

    pid = jnp.arange(n_photons, dtype=U32)
    s_ph = mrng.make_sampler(pid, pass_idx, seed ^ U32(0x5F3759DF))
    has_vol = bool(scene.media.any)
    p_ph, pw_ph, wi_ph, v_ph, vol = photon_trace(
        scene, s_ph, n_photons, max_bounces, want_volume=True)

    order, bsorted = build_grid(p_ph, v_ph, cell)
    bparams = scene.bsdf_at(_fake_it(st))
    flux, m_found = gather(
        p_ph, pw_ph, wi_ph, order, bsorted, st["p"], st["ss"], st["ts"],
        st["ns"], st["wi_local"], bparams, stats["r2"], cell, cap,
    )
    flux = jnp.where(gatherable[..., None], flux * st["thr"], 0.0)
    m_found = jnp.where(gatherable, m_found, 0.0)

    # Hachisuka update
    n_old = stats["n"]
    n_new = n_old + alpha * m_found
    ratio = jnp.where(m_found > 0, n_new / (n_old + m_found), 1.0)
    r2_new = stats["r2"] * ratio
    tau_new = (stats["tau"] + flux / n_photons) * ratio[..., None]
    ld_new = stats["ld"] + st["le"]

    if has_vol:
        # beam radiance estimate over the primary in-medium segment
        # (photonmapper/bre.cpp analog); fixed volume radius = cell,
        # averaged per pass through the ld accumulator
        vp, vpow, vwi, vvalid = vol
        order_v, bsorted_v = build_grid(vp, vvalid, cell)
        s_b = mrng.make_sampler(pix, pass_idx, seed ^ U32(0xBEA11BEA))
        _s_b, bblk = mrng.next_block4(s_b)
        lb = beam_gather(scene, vp, vpow, vwi, order_v, bsorted_v,
                         prim["o"], prim["d"], prim["t"], prim["mid"],
                         cell, cap, 24, bblk[..., 0])
        ld_new = ld_new + lb / n_photons

    return dict(r2=r2_new, n=n_new, tau=tau_new, ld=ld_new)


def render_sppm(scene: Scene, settings, spp: int | None = None,
                progress_cb=None) -> np.ndarray:
    """SPPM render; ``spp`` = number of progressive passes."""
    ip = settings.integrator_props
    W, H = settings.width, settings.height
    n_passes = spp if spp is not None else settings.spp
    md = ip.get("max_depth", -1)
    max_bounces = md if md > 0 else 8
    n_photons = int(ip.get("photon_count", 250000))
    alpha = float(ip.get("alpha", 0.7))
    cap = int(ip.get("cell_cap", 64))

    # initial radius: relative to the scene bounding-sphere radius
    # (globalLookupRadiusRelative, photonmapper.cpp)
    bsr = float(scene.emitters.bsphere_radius)
    r0 = float(ip.get("initial_radius", 0.0))
    if r0 <= 0:
        r0 = max(bsr, 1e-3) * float(ip.get("lookup_radius_rel", 0.05))
    cell = jnp.asarray(r0, Float)  # cell size = max radius (radii shrink)

    n = W * H
    stats = dict(
        r2=jnp.full((n,), r0 * r0, Float),
        n=jnp.zeros((n,), Float),
        tau=jnp.zeros((n, 3), Float),
        ld=jnp.zeros((n, 3), Float),
    )
    seed = jnp.uint32(settings.seed)
    for it in range(n_passes):
        stats = sppm_pass(scene, stats, jnp.uint32(it), seed, cell,
                          width=W, height=H, n_photons=n_photons,
                          max_bounces=max_bounces, cap=cap, alpha=alpha)
        if progress_cb is not None:
            progress_cb(it + 1, n_passes, stats)

    r2 = np.asarray(stats["r2"])
    tau = np.asarray(stats["tau"])
    ld = np.asarray(stats["ld"])
    img = tau / (n_passes * np.pi * np.maximum(r2, 1e-20))[..., None] \
        + ld / n_passes
    return img.reshape(H, W, 3).astype(np.float32)
