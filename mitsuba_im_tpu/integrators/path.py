"""Wavefront MIS path tracer.

Estimator parity with the reference ``path`` plugin
(``/root/reference/src/integrators/path/path.cpp:119-290``): NEE at every
smooth vertex + BSDF sampling, both weighted with the power heuristic
(``miWeight``, path.cpp:292), Russian roulette with eta^2 throughput scaling
from ``rrDepth`` on, ``maxDepth``/``hideEmitters``/``strictNormals``
semantics, environment handling on escape.

Wavefront design (SURVEY.md §7): instead of a per-pixel recursive ``Li()``, the
integrator advances a flat SoA batch of lanes through a ``lax.fori_loop``
over bounces with masked inactive lanes — static shapes, no divergence
beyond lane masking, everything fused by XLA.  The loop body is wrapped in
``jax.checkpoint`` so reverse-mode differentiation re-runs the wavefront
(path-replay backprop) instead of storing per-bounce intermediates.

The canonical implementation is component-SoA (:func:`path_li_v`): every
3-vector is a V3 of flat (N,) arrays, so all math is flat elementwise
work with no reduce over a trailing axis of 3.
:func:`path_li` wraps it for (N, 3)-array callers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int, INVALID, EPSILON, SHADOW_EPSILON
from ..core import v3 as v
from ..core.v3 import V3, safe_div
from ..core import rng as mrng
from ..bsdf.eval import bsdf_eval_v, bsdf_pdf_v, bsdf_sample_v
from ..emitter import table as em
from ..scene.scene import Scene


@pytree_dataclass
class PathConfig:
    max_depth: int = static_field(default=-1)
    rr_depth: int = static_field(default=5)
    hide_emitters: bool = static_field(default=False)
    strict_normals: bool = static_field(default=False)
    depth_budget: int = static_field(default=16)  # cap when max_depth == -1
    remat: bool = static_field(default=True)
    # bounces per rematerialization unit: >1 trades more live residuals
    # for fewer replays of the wavefront under reverse-mode
    remat_group: int = static_field(default=1)
    # drop depth<=2 (directly visible emitters + single-bounce direct
    # lighting): the MLT separateDirect split (mlt.cpp directSamples)
    skip_direct: bool = static_field(default=False)
    # camera bundles are coherent: they take the hierarchy's full-width
    # prologue; incoherent callers (MCMC chain evals, hemisphere gathers)
    # set False to skip it
    coherent: bool = static_field(default=True)


def mi_weight(pdf_a, pdf_b):
    """Power heuristic (path.cpp:292)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return safe_div(a2, a2 + b2)


def path_li_v(scene: Scene, sampler: mrng.Sampler3, o: V3, d: V3,
              cfg: PathConfig, dddx: V3 | None = None,
              dddy: V3 | None = None):
    """Trace a batch of primary rays to completion (component-SoA).

    Returns (radiance V3 of (N,) components, sampler) — the sampler is
    advanced by a fixed number of dimensions per bounce so replay is
    deterministic.
    """
    n = o.x.shape[0]
    n_iters = max(cfg.max_depth - 1, 0) if cfg.max_depth > 0 else cfg.depth_budget

    li = v.zeros((n,))
    thr = v.ones((n,))

    hit = scene.ray_intersect_v(o, d, coherent=cfg.coherent)
    it = scene.interaction_v(o, d, hit)

    # directly visible emitters / environment (depth-1 contributions)
    esc = ~it.valid
    if not cfg.hide_emitters and not cfg.skip_direct:
        env = em.eval_environment_v(scene.emitters, d)
        li = li + v.where(esc, thr * env, v.zeros((n,)))
        eid0 = scene.emitter_at_id(it.shape)
        le0 = em.emitted_radiance_v(scene.emitters, eid0, it.ns, -d)
        li = li + v.where(it.valid, thr * le0, v.zeros((n,)))

    # ray differentials -> MIP/aniso texture filtering at the primary hit
    use_duv = dddx is not None and dddy is not None and scene.textures.has_mip
    state = dict(
        li=li, thr=thr, eta=jnp.ones((n,), Float), active=it.valid,
        scattered=jnp.zeros((n,), bool),
        p=it.p, ns=it.ns, ng=it.ng, ss=it.ss, ts=it.ts_,
        uv_u=it.uv_u, uv_v=it.uv_v,
        shape=it.shape, wi_local=it.wi_local, d_world=d,
        sampler=sampler,
    )
    if use_duv:
        from ..render.raydiff import uv_differentials

        duv0 = uv_differentials(scene.geom, hit, o, d, dddx, dddy)
    else:
        duv0 = None

    def bounce(depth_idx, st, duv=None, skip_first=False):
        """One NEE + BSDF-extension step at the current vertex.

        ``skip_first`` (Python-static) marks the peeled first bounce under
        ``cfg.skip_direct``: its depth-2 contributions are dropped without
        any traced depth comparison — the traced ``depth_idx > 0`` form
        once miscompiled under whole-program jit on an accelerator backend
        (most lanes kept their depth-2 light while eager execution and the
        CPU agreed on the correct value; pinned by parity_check.py's
        skip_direct scene)."""
        s = st["sampler"]
        frame = (st["ss"], st["ts"], st["ns"])
        act = st["active"]
        fake_it = _fake_it_v(st)
        if scene.bsdfs.unwrap_depth > 0:
            s, sel_blk = mrng.next_block4_v(s)
            bparams = scene.bsdf_at_v(fake_it, u_sel=sel_blk[0], duv=duv)
        else:
            bparams = scene.bsdf_at_v(fake_it, duv=duv)

        # --- subsurface scattering (its.LoSub analog) ----------------------
        st_li0 = st["li"]
        if scene.subsurface is not None:
            from ..subsurface import eval_lo, eval_lo_single

            ss_id = scene.subsurface_at(st["shape"], act)
            lo_sub = V3.from_array(eval_lo(
                scene.subsurface, st["p"].to_array(),
                jnp.abs(st["wi_local"].z), ss_id))
            st_li0 = st_li0 + v.where(act, st["thr"] * lo_sub, v.zeros((n,)))
            if scene.subsurface.has_single:
                s, ss_blk = mrng.next_block4_v(s)
                lo_ss = eval_lo_single(
                    scene.subsurface, scene, st["p"], st["ns"],
                    st["d_world"], ss_id, ss_blk)
                st_li0 = st_li0 + v.where(act, st["thr"] * lo_ss,
                                          v.zeros((n,)))

        # --- next-event estimation (sampleEmitterDirect, path.cpp:176) ----
        s, nee_blk = mrng.next_block4_v(s)
        ds = em.sample_direct_v(
            scene.emitters, scene.geom, st["p"],
            nee_blk[0], nee_blk[1], nee_blk[2],
        )
        wo_local_nee = v.to_local(frame, ds.d)
        f_nee = bsdf_eval_v(bparams, st["wi_local"], wo_local_nee)
        pdf_bsdf_nee = bsdf_pdf_v(bparams, st["wi_local"], wo_local_nee)
        can_nee = act & (ds.pdf > 0) & (f_nee.sum() > 0)
        occ = scene.occluded_v(
            st["p"], ds.d, EPSILON, ds.dist * (1.0 - SHADOW_EPSILON),
            active=can_nee,
        )
        w_nee = jnp.where(ds.delta, 1.0, mi_weight(ds.pdf, pdf_bsdf_nee))
        contrib = st["thr"] * ds.value * f_nee * safe_div(w_nee, ds.pdf)
        keep_nee = can_nee & ~occ
        if skip_first:
            keep_nee = jnp.zeros_like(keep_nee)
        st_li = st_li0 + v.where(keep_nee, contrib, v.zeros((n,)))

        # --- BSDF sampling (path.cpp:211) ---------------------------------
        s, bsdf_blk = mrng.next_block4_v(s)
        bs = bsdf_sample_v(bparams, st["wi_local"], bsdf_blk[0],
                           bsdf_blk[1], bsdf_blk[2], bsdf_blk[3])
        wo_world = v.to_world(frame, bs.wo)
        thr_new = st["thr"] * bs.weight
        dead = thr_new.sum() <= 0
        act2 = act & ~dead
        scattered = st["scattered"] | (act & ~bs.null_passthrough)
        eta_new = st["eta"] * bs.eta

        # extend the path
        o2 = st["p"]
        hit2 = scene.ray_intersect_v(o2, wo_world, active=act2)
        it2 = scene.interaction_v(o2, wo_world, hit2)

        # emitter hit / environment with MIS (path.cpp:249-266)
        eid2 = scene.emitter_at_id(it2.shape)
        le2 = em.emitted_radiance_v(scene.emitters, eid2, it2.ns, -wo_world)
        lum_pdf_area = em.pdf_direct_area_v(
            scene.emitters, eid2, st["p"], it2.p, it2.ns
        )
        esc2 = ~it2.valid
        env_val = em.eval_environment_v(scene.emitters, wo_world)
        env_pdf = em.pdf_direct_env_v(scene.emitters, wo_world)

        lum_pdf = jnp.where(bs.delta, 0.0,
                            jnp.where(esc2, env_pdf, lum_pdf_area))
        w_bsdf = mi_weight(bs.pdf, lum_pdf)
        hit_val = v.where(esc2, env_val, le2)
        hide = cfg.hide_emitters & ~scattered
        keep_hit = act2 & ~hide
        if skip_first:
            keep_hit = jnp.zeros_like(keep_hit)
        st_li = st_li + v.where(
            keep_hit, thr_new * hit_val * w_bsdf, v.zeros((n,))
        )

        act3 = act2 & it2.valid

        # --- Russian roulette (path.cpp:276-290) ---------------------------
        depth = depth_idx + 1  # reference depth counter before increment
        s, rr_blk = mrng.next_block4_v(s)
        u_rr = rr_blk[0]
        q = jnp.minimum(thr_new.max_c() * eta_new * eta_new, 0.95)
        do_rr = depth >= cfg.rr_depth
        kill = do_rr & (u_rr >= q)
        boost = 1.0 / jnp.maximum(q, 1e-6)
        thr_new = v.where(do_rr & ~kill, thr_new * boost, thr_new)
        act3 = act3 & ~kill

        return dict(
            li=st_li, thr=thr_new, eta=eta_new, active=act3,
            scattered=scattered,
            p=it2.p, ns=it2.ns, ng=it2.ng, ss=it2.ss, ts=it2.ts_,
            uv_u=it2.uv_u, uv_v=it2.uv_v,
            shape=it2.shape, wi_local=it2.wi_local, d_world=wo_world,
            sampler=s,
        )

    body = bounce
    if cfg.remat:
        body = jax.checkpoint(bounce, prevent_cse=False)
    start = 0
    if (use_duv or cfg.skip_direct) and n_iters > 0:
        # peel the first bounce: only it consumes the pixel footprint
        # (filtered textures) and only it drops depth-2 light under
        # skip_direct — both are Python-static in the peeled call, so the
        # loop body compiles without either path
        first = lambda st: bounce(0, st, duv0 if use_duv else None,
                                  skip_first=cfg.skip_direct)
        if cfg.remat:
            first = jax.checkpoint(first, prevent_cse=False)
        state = first(state)
        start = 1
    g = max(int(cfg.remat_group), 1)
    if cfg.remat and g > 1 and (n_iters - start) >= g:
        n_groups = (n_iters - start) // g

        def group_body(j, st):
            for q in range(g):
                st = bounce(start + j * g + q, st)
            return st

        state = jax.lax.fori_loop(
            0, n_groups, jax.checkpoint(group_body, prevent_cse=False),
            state)
        state = jax.lax.fori_loop(start + n_groups * g, n_iters, body,
                                  state)
    else:
        state = jax.lax.fori_loop(start, n_iters, body, state)
    return state["li"], state["sampler"]


def _fake_it_v(st):
    """Adapter: scene.bsdf_at_v consumes an Interaction3-shaped object."""
    from ..scene.geometry import Interaction3

    return Interaction3(
        p=st["p"], t=jnp.zeros(st["uv_u"].shape, Float), ng=st["ng"],
        ns=st["ns"], ss=st["ss"], ts_=st["ts"], uv_u=st["uv_u"],
        uv_v=st["uv_v"], wi_local=st["wi_local"], shape=st["shape"],
        valid=st["active"],
    )


def _fake_it(st):
    """Adapter for (N, 3)-array integrators: scene.bsdf_at consumes an
    Interaction-shaped object."""
    from ..scene.geometry import Interaction

    return Interaction(
        p=st["p"], t=jnp.zeros(st["p"].shape[:-1], Float), ng=st["ng"],
        ns=st["ns"], ss=st["ss"], ts_=st["ts"], uv=st["uv"],
        wi_local=st["wi_local"], shape=st["shape"], valid=st["active"],
    )


def path_li(scene: Scene, sampler: mrng.SamplerState, o: jax.Array,
            d: jax.Array, cfg: PathConfig, dddx: jax.Array | None = None,
            dddy: jax.Array | None = None):
    """(N, 3)-array wrapper around :func:`path_li_v`.

    The SamplerState and Sampler3 hash streams are bitwise identical, so
    existing callers (and checkpointed renders) see unchanged images.
    ``dddx``/``dddy``: optional (N, 3) primary-ray direction differentials
    (one-pixel film offsets) enabling MIP/aniso texture filtering.
    """
    s3 = mrng.Sampler3(
        pixel=sampler.pixel, sample=sampler.sample,
        b0=sampler.base[..., 0], b1=sampler.base[..., 1],
        b2=sampler.base[..., 2], b3=sampler.base[..., 3],
        dim=sampler.dim, seed=sampler.seed, table=sampler.table,
        kind=sampler.kind, spp=sampler.spp,
    )
    li, s3 = path_li_v(
        scene, s3, V3.from_array(o), V3.from_array(d), cfg,
        dddx=None if dddx is None else V3.from_array(dddx),
        dddy=None if dddy is None else V3.from_array(dddy),
    )
    return li.to_array(), sampler.replace(dim=s3.dim)
