"""Volumetric wavefront path tracer (homogeneous + heterogeneous media).

Estimator parity with the reference ``volpath`` plugin
(``/root/reference/src/integrators/path/volpath.cpp``): free-flight distance
sampling raced against the surface hit, phase-function scattering with
NEE + MIS at medium vertices, surface interactions as in the MIS path
tracer, medium transitions at transmissive boundaries, attenuated shadow
rays through null boundaries (``Scene::sampleAttenuatedEmitterDirect``
analog, scene.cpp), and Russian roulette.

Wavefront shape: the same masked-lane ``fori_loop`` wavefront as ``path_li`` with
a per-lane medium id; emitter-hit MIS carries the previous vertex's
directional pdf through the loop state.  Like the path tracer, the
canonical implementation is component-SoA (V3 of flat (N,) arrays); ``volpath_li`` wraps it for (N, 3)-array callers.

Medium models: homogeneous sigma_s/sigma_a with channel-averaged
free-flight sampling and spectral reweighting; heterogeneous grid media
(heterogeneous.cpp) with delta-tracking distance sampling and
ratio-tracking shadow transmittance (exact weights since grid sigma_t is
spectrally uniform).  Both kinds coexist per-lane; hetero branches compile
away when the scene has no grid media (static ``scene.media.has_hetero``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Float, Int, INVALID, EPSILON, SHADOW_EPSILON
from ..core import v3 as v
from ..core.v3 import V3, safe_div
from ..core import rng as mrng
from ..bsdf.eval import bsdf_eval_v, bsdf_pdf_v, bsdf_sample_v
from ..bsdf.common import NULL_BSDF
from ..emitter import table as em
from ..media import medium as med
from ..scene.scene import Scene
from .path import PathConfig, mi_weight, _fake_it_v

MAX_NULL_SEGMENTS = 4  # shadow-ray march depth through null boundaries


def _medium_transition_v(scene: Scene, shape_id, d_world: V3, ng: V3,
                         cur_medium):
    """New medium id after crossing a surface along d_world."""
    sid = jnp.where(shape_id == INVALID, 0, shape_id)
    interior = v.gather_col(scene.shape_interior, sid)
    exterior = v.gather_col(scene.shape_exterior, sid)
    entering = d_world.dot(ng) < 0
    new = jnp.where(entering, interior, exterior)
    has_spec = (interior != INVALID) | (exterior != INVALID)
    return jnp.where((shape_id != INVALID) & has_spec, new, cur_medium)


def attenuated_occlusion_v(scene: Scene, o: V3, d: V3, dist, medium0, s):
    """Transmittance along a shadow segment through up to MAX_NULL_SEGMENTS
    null/mask boundaries; zero when blocked by an opaque surface.
    Heterogeneous lanes estimate per-segment transmittance by ratio
    tracking (unbiased); returns (sampler, transmittance V3)."""
    has_het = scene.media.has_hetero
    n = o.x.shape[0]
    trans = v.ones((n,))
    seg_o = o
    remaining = dist
    mid = medium0
    alive = jnp.ones((n,), bool)

    for _ in range(MAX_NULL_SEGMENTS):
        hit = scene.ray_intersect_v(seg_o, d, EPSILON,
                                    remaining * (1.0 - SHADOW_EPSILON))
        seg_len = jnp.where(hit.valid, hit.t, remaining)
        _ss, st, _pt, _g = med.medium_params_v(scene.media, mid)
        seg_trans = med.transmittance_v(st, seg_len)
        if has_het:
            rows = med.hetero_rows_v(scene.media, mid)
            s, t_ratio = med.track_transmittance_v(
                scene.media, rows, seg_o, d, seg_len, s, alive)
            seg_trans = v.where(rows["is_het"],
                                V3(t_ratio, t_ratio, t_ratio), seg_trans)
        trans = trans * v.where(alive, seg_trans, v.ones((n,)))
        it = scene.interaction_v(seg_o, d, hit)
        p = scene.bsdf_at_v(it)
        pass_null = p.type == NULL_BSDF
        pass_mask = (~pass_null) & (p.opacity < 1.0)
        is_null = pass_null | pass_mask
        att = jnp.where(alive & hit.valid & pass_mask, 1.0 - p.opacity, 1.0)
        trans = trans * att
        blocked = alive & hit.valid & ~is_null
        trans = v.where(blocked, v.zeros((n,)), trans)
        mid = jnp.where(
            alive & hit.valid & is_null,
            _medium_transition_v(scene, it.shape, d, it.ng, mid), mid,
        )
        seg_o = v.where(hit.valid, it.p, seg_o)
        remaining = jnp.where(hit.valid, remaining - seg_len, 0.0)
        alive = alive & hit.valid & is_null & (remaining > EPSILON)

    trans = v.where(alive, v.zeros((n,)), trans)  # budget exceeded: opaque
    return s, trans


def volpath_li_v(scene: Scene, sampler: mrng.Sampler3, o: V3, d: V3,
                 cfg: PathConfig):
    """Volumetric Li over a component-SoA ray batch."""
    has_media = scene.media.any
    n = o.x.shape[0]
    max_depth_eff = cfg.max_depth if cfg.max_depth > 0 else 1 << 20
    n_iters = cfg.max_depth if cfg.max_depth > 0 else cfg.depth_budget + 1

    state = dict(
        li=v.zeros((n,)),
        thr=v.ones((n,)),
        eta=jnp.ones((n,), Float),
        active=jnp.ones((n,), bool),
        scattered=jnp.zeros((n,), bool),
        o=o, d=d,
        medium=jnp.full((n,), scene.camera_medium, Int),
        prev_pdf=jnp.zeros((n,), Float),
        prev_delta=jnp.ones((n,), bool),  # first segment: no MIS partner
        sampler=sampler,
    )

    def bounce(depth_idx, st):
        s = st["sampler"]
        act = st["active"]
        o_c, d_c = st["o"], st["d"]

        hit = scene.ray_intersect_v(o_c, d_c)
        it = scene.interaction_v(o_c, d_c, hit)
        t_surf = jnp.where(hit.valid, hit.t, 1e30)

        # --- free flight vs surface (volpath.cpp sampleDistance) ----------
        s, blk_m = mrng.next_block4_v(s)
        sigma_s, sigma_t, ptype, g = med.medium_params_v(
            scene.media, st["medium"])
        in_medium = (st["medium"] != INVALID) & act
        if has_media:
            t_m, st_bar = med.sample_distance_v(sigma_t, blk_m[0])
            med_scatter = in_medium & (t_m < t_surf)
            pdf_t = st_bar * jnp.exp(-st_bar * t_m)
            w_med = sigma_s * med.transmittance_v(sigma_t, t_m) * (
                1.0 / jnp.maximum(pdf_t, 1e-30))
            p_surf = jnp.exp(-st_bar * jnp.minimum(
                t_surf, 80.0 / jnp.maximum(st_bar, 1e-20)))
            w_srf = med.transmittance_v(sigma_t, t_surf) * (
                1.0 / jnp.maximum(p_surf, 1e-30))
            one = v.ones((n,))
            w_seg = v.where(med_scatter, w_med,
                            v.where(in_medium, w_srf, one))
            if scene.media.has_hetero:
                # delta tracking replaces the closed-form race on grid lanes
                rows = med.hetero_rows_v(scene.media, st["medium"])
                is_het = rows["is_het"]
                s, t_het, het_sc = med.track_distance_v(
                    scene.media, rows, o_c, d_c, t_surf, s, in_medium)
                alb = med.albedo_at_v(scene.media, rows, o_c + d_c * t_het)
                med_scatter = jnp.where(is_het, het_sc, med_scatter)
                t_m = jnp.where(is_het, t_het, t_m)
                # exact weights: albedo(x) on real collision, 1 on escape
                w_het = v.where(het_sc, alb, one)
                w_seg = v.where(is_het,
                                v.where(in_medium, w_het, one), w_seg)
        else:
            t_m = jnp.zeros((n,), Float)
            med_scatter = jnp.zeros((n,), bool)
            w_seg = v.ones((n,))
        thr = st["thr"] * v.where(act, w_seg, v.ones((n,)))

        # --- emission at the segment end (MIS vs previous NEE) ------------
        esc = act & ~med_scatter & ~hit.valid
        surf = act & ~med_scatter & hit.valid
        eid = scene.emitter_at_id(it.shape)
        le = em.emitted_radiance_v(scene.emitters, eid, it.ns, -d_c)
        lum_pdf = jnp.where(
            surf,
            em.pdf_direct_area_v(scene.emitters, eid, o_c, it.p, it.ns),
            em.pdf_direct_env_v(scene.emitters, d_c),
        )
        w_hit = jnp.where(st["prev_delta"], 1.0,
                          mi_weight(st["prev_pdf"], lum_pdf))
        env_val = em.eval_environment_v(scene.emitters, d_c)
        hide = cfg.hide_emitters & ~st["scattered"]
        emit_val = v.where(esc, env_val,
                           v.where(surf, le, v.zeros((n,))))
        li = st["li"] + v.where((esc | surf) & ~hide,
                                thr * emit_val * w_hit, v.zeros((n,)))

        # --- scattering vertex ---------------------------------------------
        depth = depth_idx + 1
        do_scatter = (depth < max_depth_eff) & (med_scatter | surf)
        p_vert = v.where(med_scatter, o_c + d_c * t_m, it.p)

        u_sel = None
        if scene.bsdfs.unwrap_depth > 0:
            s, sel_blk = mrng.next_block4_v(s)
            u_sel = sel_blk[0]
        bparams = scene.bsdf_at_v(_fake_it_v({
            "p": it.p, "ng": it.ng, "ns": it.ns, "ss": it.ss, "ts": it.ts_,
            "uv_u": it.uv_u, "uv_v": it.uv_v, "wi_local": it.wi_local,
            "shape": it.shape, "active": surf,
        }), u_sel=u_sel)
        frame = (it.ss, it.ts_, it.ns)

        # NEE (surface: bsdf eval; medium: phase eval), attenuated shadow ray
        s, nee_blk = mrng.next_block4_v(s)
        ds = em.sample_direct_v(scene.emitters, scene.geom, p_vert,
                                nee_blk[0], nee_blk[1], nee_blk[2])
        wo_nee_local = v.to_local(frame, ds.d)
        f_surf = bsdf_eval_v(bparams, it.wi_local, wo_nee_local)
        pdf_surf_nee = bsdf_pdf_v(bparams, it.wi_local, wo_nee_local)
        pctx = med.phase_ctx_v(scene.media, st["medium"], p_vert)
        # phase API convention: wi points TOWARD the previous vertex (like
        # BSDFs), i.e. -d_c here; passing the propagation direction flips
        # anisotropic lobes to g -> -g (caught by the bdpt medium-vertex
        # ground-truth comparison: volpath measured 16% dim at g=0.3)
        wi_ph = v.V3(-d_c.x, -d_c.y, -d_c.z)
        ph_nee = med.phase_eval_ctx_v(scene.media, pctx, wi_ph, ds.d)
        ph_nee_pdf = med.phase_pdf_ctx_v(scene.media, pctx, wi_ph, ds.d)
        f_phase = V3(ph_nee, ph_nee, ph_nee)
        f_nee = v.where(med_scatter, f_phase, f_surf)
        pdf_fwd_nee = jnp.where(med_scatter, ph_nee_pdf, pdf_surf_nee)
        if has_media:
            s, trans_sh = attenuated_occlusion_v(scene, p_vert, ds.d,
                                                 ds.dist, st["medium"], s)
        else:
            occ = scene.occluded_v(p_vert, ds.d, EPSILON,
                                   ds.dist * (1.0 - SHADOW_EPSILON))
            trans_sh = v.where(occ, v.zeros((n,)), v.ones((n,)))
        w_nee = jnp.where(ds.delta, 1.0, mi_weight(ds.pdf, pdf_fwd_nee))
        contrib = thr * ds.value * f_nee * trans_sh * safe_div(w_nee, ds.pdf)
        li = li + v.where(do_scatter & (ds.pdf > 0), contrib, v.zeros((n,)))

        # direction sampling
        s, sc_blk = mrng.next_block4_v(s)
        bs = bsdf_sample_v(bparams, it.wi_local, sc_blk[0],
                           sc_blk[1], sc_blk[2], sc_blk[3])
        wo_surf = v.to_world(frame, bs.wo)
        wo_phase, pdf_phase, w_phase = med.phase_sample_ctx_v(
            scene.media, pctx, wi_ph, sc_blk[1], sc_blk[2], sc_blk[3])
        wo = v.where(med_scatter, wo_phase, wo_surf)
        # phase importance weight: 1 for value-proportional families,
        # eval/pdf for the structured phases (kkay/microflake)
        w_dir = v.where(med_scatter, V3(w_phase, w_phase, w_phase),
                        bs.weight)
        thr_new = thr * v.where(do_scatter, w_dir, v.ones((n,)))
        # null/mask passthrough is not a scattering event: keep the previous
        # vertex's MIS pdf, else the env/area hit after the boundary gets
        # weight 1 on top of the NEE estimate (double counting)
        prev_pdf = jnp.where(
            med_scatter, pdf_phase,
            jnp.where(bs.null_passthrough, st["prev_pdf"], bs.pdf),
        )
        prev_delta = jnp.where(
            med_scatter, jnp.zeros_like(bs.delta),
            jnp.where(bs.null_passthrough, st["prev_delta"], bs.delta),
        )
        scattered = st["scattered"] | (
            do_scatter & (med_scatter | ~bs.null_passthrough))

        # medium transition across transmissive surfaces
        crossed = surf & (wo.dot(it.ng) * (-d_c).dot(it.ng) < 0)
        mid_new = jnp.where(
            do_scatter & crossed,
            _medium_transition_v(scene, it.shape, wo, it.ng, st["medium"]),
            st["medium"],
        )
        eta_new = st["eta"] * jnp.where(do_scatter & surf, bs.eta, 1.0)

        dead = thr_new.sum() <= 0
        act2 = act & do_scatter & ~dead

        # --- Russian roulette ---------------------------------------------
        s, rr_blk = mrng.next_block4_v(s)
        q = jnp.minimum(thr_new.max_c() * eta_new * eta_new, 0.95)
        do_rr = depth >= cfg.rr_depth
        kill = do_rr & (rr_blk[0] >= q)
        thr_new = v.where(do_rr & ~kill,
                          thr_new * (1.0 / jnp.maximum(q, 1e-6)), thr_new)
        act2 = act2 & ~kill

        return dict(
            li=li, thr=thr_new, eta=eta_new, active=act2, scattered=scattered,
            o=p_vert, d=wo, medium=mid_new,
            prev_pdf=prev_pdf, prev_delta=prev_delta,
            sampler=s,
        )

    body = bounce
    if cfg.remat:
        body = jax.checkpoint(bounce, prevent_cse=False)
    state = jax.lax.fori_loop(0, n_iters, body, state)
    return state["li"], state["sampler"]


def volpath_li(scene: Scene, sampler: mrng.SamplerState, o: jax.Array,
               d: jax.Array, cfg: PathConfig):
    """(N, 3)-array wrapper around :func:`volpath_li_v` (bitwise-identical
    sampler streams, see path.path_li)."""
    s3 = mrng.Sampler3(
        pixel=sampler.pixel, sample=sampler.sample,
        b0=sampler.base[..., 0], b1=sampler.base[..., 1],
        b2=sampler.base[..., 2], b3=sampler.base[..., 3],
        dim=sampler.dim, seed=sampler.seed, table=sampler.table,
        kind=sampler.kind, spp=sampler.spp,
    )
    li, s3 = volpath_li_v(scene, s3, V3.from_array(o), V3.from_array(d), cfg)
    return li.to_array(), sampler.replace(dim=s3.dim)
