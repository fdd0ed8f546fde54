"""Adjoint particle tracer (light tracing into the sensor).

Parity target: ``/root/reference/src/integrators/ptracer/``
(``CaptureParticleWorker`` tracing emitter paths and splatting sensor
connections) built on the particle-tracing infrastructure
(``include/mitsuba/render/particleproc.h:45``).

Wavefront shape: a flat batch of light particles advances through a masked
``fori_loop``; at every vertex a camera connection is evaluated
(``sensor.connect``) and appended to a per-bounce splat list which the
render job scatter-adds into the film.  The estimator matches the
camera-sampled path tracer in expectation:

    I_px ~= (W*H / N) * sum thr * f(x->cam) * G * W_e

with W_e the pinhole image-plane importance (sensor/table.py connect).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import Float, Int, INVALID, EPSILON, SHADOW_EPSILON
from ..core import math as m
from ..core import warp
from ..core import rng as mrng
from ..bsdf.eval import bsdf_eval, bsdf_sample
from ..emitter import table as em
from ..scene.scene import Scene
from ..sensor.table import connect as sensor_connect
from .path import PathConfig, _fake_it


class LightSample(NamedTuple):
    p: jax.Array  # (..., 3) position on the emitter
    d: jax.Array  # (..., 3) emitted direction
    n: jax.Array  # (..., 3) emitter normal (delta types: direction)
    weight: jax.Array  # (..., 3) Le * cos / (pdf_pos * pdf_dir * sel_pmf)
    delta_pos: jax.Array  # point-like emitter (no area connection factor)


def sample_emitter_ray(scene: Scene, u_sel, u_pos, u_dir) -> LightSample:
    """Sample an emitted ray (Scene::sampleEmitterRay, scene.h:885)."""
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
    d = jnp.zeros(shape + (3,), Float)
    n = jnp.zeros(shape + (3,), Float)
    w = jnp.zeros(shape + (3,), Float)
    delta_pos = jnp.zeros(shape, bool)

    for t in emt.used_types:
        sel = etype == t
        if t == em.EM_AREA:
            p_s, n_s, pdf_a = em._sample_area_position(emt, scene.geom, eid, u_pos, eb)
            d_local = warp.square_to_cosine_hemisphere(u_dir)
            fr = m.Frame.from_normal(n_s)
            d_s = m.Frame.to_world(fr, d_local)
            # weight = Le cos / (pdf_a * cos/pi) = Le * pi / pdf_a
            w_s = eb["radiance"] * (jnp.pi / jnp.maximum(pdf_a, 1e-20))[..., None]
            p, d, n, w = _sel4(sel, (p_s, d_s, n_s, w_s), (p, d, n, w))
        elif t in (em.EM_POINT, em.EM_SPOT):
            d_s = warp.square_to_uniform_sphere(u_dir)
            w_s = eb["intensity"] * (4.0 * jnp.pi)
            if t == em.EM_SPOT:
                cd = m.dot(d_s, eb["direction"])
                cc = eb["cos_cutoff"]
                cf = eb["cos_falloff"]
                fall = jnp.clip((cd - cc) / jnp.maximum(cf - cc, 1e-6), 0.0, 1.0)
                w_s = w_s * jnp.where(cd > cc, fall, 0.0)[..., None]
            p, d, n, w = _sel4(
                sel, (jnp.broadcast_to(eb["position"], p.shape), d_s, d_s, w_s),
                (p, d, n, w),
            )
            delta_pos = jnp.where(sel, True, delta_pos)
        elif t == em.EM_DIRECTIONAL:
            # launch from a disk on the bounding sphere facing `direction`
            dir_e = eb["direction"]
            disk = warp.square_to_uniform_disk_concentric(u_pos)
            fr = m.Frame.from_normal(dir_e)
            r = emt.bsphere_radius
            off = m.Frame.to_world(
                fr, m.vec3(disk[..., 0] * r, disk[..., 1] * r, jnp.zeros(shape))
            )
            p_s = emt.bsphere_center - dir_e * (1.1 * r)[..., None] + off
            area = jnp.pi * r * r
            w_s = eb["intensity"] * area
            p, d, n, w = _sel4(sel, (p_s, dir_e, dir_e, w_s), (p, d, n, w))
            delta_pos = jnp.where(sel, True, delta_pos)
        elif t in (em.EM_CONSTANT, em.EM_ENVMAP):
            # inward ray from the bounding sphere
            dir_in = -warp.square_to_uniform_sphere(u_pos)  # toward scene
            sph = warp.square_to_uniform_sphere(u_pos)
            disk = warp.square_to_uniform_disk_concentric(u_dir)
            r = emt.bsphere_radius
            fr = m.Frame.from_normal(dir_in)
            p_s = (
                emt.bsphere_center - dir_in * (1.1 * r)[..., None]
                + m.Frame.to_world(
                    fr, m.vec3(disk[..., 0] * r, disk[..., 1] * r, jnp.zeros(shape))
                )
            )
            if t == em.EM_CONSTANT:
                le = jnp.broadcast_to(eb["radiance"], p.shape)
            else:
                le = em._env_lookup(emt, em._env_uv_from_dir(emt, -dir_in), eb["radiance"])
            # pdf_dir = 1/(4pi) over sphere; pdf_pos = 1/(pi r^2) over disk
            w_s = le * (4.0 * jnp.pi * jnp.pi * r * r)
            p, d, n, w = _sel4(sel, (p_s, dir_in, dir_in, w_s), (p, d, n, w))
            delta_pos = jnp.where(sel, True, delta_pos)
        elif t == em.EM_COLLIMATED:
            p_s = jnp.broadcast_to(eb["position"], p.shape)
            dir_e = eb["direction"]
            w_s = jnp.broadcast_to(eb["intensity"], p.shape)
            p, d, n, w = _sel4(sel, (p_s, dir_e, dir_e, w_s), (p, d, n, w))
            delta_pos = jnp.where(sel, True, delta_pos)

    return LightSample(p=p, d=d, n=n, weight=w / sel_pmf[..., None],
                       delta_pos=delta_pos)


def _sel4(mask, new, old):
    out = []
    for nv, ov in zip(new, old):
        mm = mask[..., None] if nv.ndim > mask.ndim else mask
        out.append(jnp.where(mm, nv, ov))
    return tuple(out)


def ptracer_splats(scene: Scene, sampler: mrng.SamplerState, n_particles: int,
                   cfg: PathConfig):
    """Trace light particles; returns (uv (K, B, 2), value (K, B, 3), valid)
    splat lists with K = max bounces + 1 camera connections per particle."""
    s = sampler
    s, blk = mrng.next_block4(s)
    s, blk2 = mrng.next_block4(s)
    ls = sample_emitter_ray(scene, blk[..., 0], blk[..., 1:3], blk2[..., 0:2])

    n_iters = (cfg.max_depth - 1) if cfg.max_depth > 0 else cfg.depth_budget

    def connect_from_surface(it, bparams, thr, act):
        """Contribution of connecting the current surface vertex to the eye."""
        uv, cam, dist, We, vis_ok = sensor_connect(scene.sensor, it.p)
        d_cam = (cam - it.p) / jnp.maximum(dist, 1e-12)[..., None]
        wo_local = it.to_local(d_cam)
        f = bsdf_eval(bparams, it.wi_local, wo_local)  # includes |cos_surface|
        occ = scene.occluded(it.p, d_cam, EPSILON, dist * (1.0 - SHADOW_EPSILON))
        g = 1.0 / jnp.maximum(dist * dist, 1e-12)
        val = thr * f * (We * g)[..., None]
        ok = act & vis_ok & ~occ
        return uv, jnp.where(ok[..., None], val, 0.0), ok

    # initial intersection
    hit = scene.ray_intersect(ls.p, ls.d)
    it = scene.interaction(ls.p, ls.d, hit)

    uvs = []
    vals = []

    # depth-0 connection: the emitter surface seen directly by the camera
    # (CaptureParticleWorker::handleEmission analog)
    emt = scene.emitters
    if emt.n_emitters > 0 and em.EM_AREA in emt.used_types:
        uv0, cam0, dist0, We0, vis0 = sensor_connect(scene.sensor, ls.p)
        d_cam0 = (cam0 - ls.p) / jnp.maximum(dist0, 1e-12)[..., None]
        cos_e = m.dot(ls.n, d_cam0)
        occ0 = scene.occluded(ls.p, d_cam0, EPSILON, dist0 * (1.0 - SHADOW_EPSILON))
        # ls.weight = Le*pi/pdf_pos (cosine dir pdf folded); the position-only
        # connection needs Le/pdf_pos: divide the pi back out and apply cos_e
        val0 = ls.weight * (
            jnp.maximum(cos_e, 0.0) / jnp.pi * We0 / jnp.maximum(dist0 * dist0, 1e-12)
        )[..., None]
        ok0 = vis0 & ~occ0 & ~ls.delta_pos & (cos_e > 0)
        uvs.append(uv0)
        vals.append(jnp.where(ok0[..., None], val0, 0.0))

    state = dict(
        thr=ls.weight, active=it.valid,
        p=it.p, ns=it.ns, ng=it.ng, ss=it.ss, ts=it.ts_, uv=it.uv,
        shape=it.shape, wi_local=it.wi_local,
        sampler=s,
    )

    # static unroll so each bounce appends a splat record
    for depth in range(1, n_iters + 1):
        st = state
        bparams = scene.bsdf_at(_fake_it(st))
        it_cur = _fake_it(st)
        uv_c, val_c, ok_c = connect_from_surface(it_cur, bparams, st["thr"], st["active"])
        uvs.append(uv_c)
        vals.append(val_c)

        s = st["sampler"]
        s, bsdf_blk = mrng.next_block4(s)
        bs = bsdf_sample(bparams, st["wi_local"], bsdf_blk[..., 0],
                         bsdf_blk[..., 1:3], bsdf_blk[..., 3])
        frame = (st["ss"], st["ts"], st["ns"])
        wo_world = m.Frame.to_world(frame, bs.wo)
        thr = st["thr"] * bs.weight
        act = st["active"] & (jnp.sum(thr, axis=-1) > 0)

        # RR
        s, rr_blk = mrng.next_block4(s)
        q = jnp.minimum(jnp.max(thr, axis=-1), 0.95)
        do_rr = depth >= cfg.rr_depth
        kill = do_rr & (rr_blk[..., 0] >= q)
        thr = jnp.where((do_rr & ~kill)[..., None], thr / jnp.maximum(q, 1e-6)[..., None], thr)
        act = act & ~kill

        hit2 = scene.ray_intersect(st["p"], wo_world)
        it2 = scene.interaction(st["p"], wo_world, hit2)
        act = act & it2.valid
        state = dict(
            thr=thr, active=act,
            p=it2.p, ns=it2.ns, ng=it2.ng, ss=it2.ss, ts=it2.ts_, uv=it2.uv,
            shape=it2.shape, wi_local=it2.wi_local,
            sampler=s,
        )

    return jnp.stack(uvs), jnp.stack(vals)
