"""Instant-radiosity VPL integrator.

Parity target: ``/root/reference/src/integrators/vpl/vpl.cpp`` — generate
virtual point lights by random walks from the emitters
(``src/librender/vpl.cpp`` generateVPLs), then light every pixel by summing
the direct contribution of each VPL with a clamped geometry term.

Wavefront shape: the VPL set is a small SoA array; the render is a
``lax.fori_loop`` over VPLs where each iteration evaluates ALL pixels
against one VPL (one shadow-ray wavefront + two vectorized BSDF evals) —
the transpose of the reference's per-pixel VPL loop, chosen so every step
is a full-width batched op.  Direct illumination uses one NEE sample per
pixel (the reference folds emitter-surface VPLs into the set; separating
direct keeps the clamping bias confined to indirect light).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import Float, EPSILON, SHADOW_EPSILON
from ..core import math as m
from ..core import rng as mrng
from ..bsdf.eval import bsdf_eval, bsdf_pdf
from ..emitter import table as em
from ..scene.scene import Scene
from .path import _fake_it, mi_weight
from .sppm import photon_trace, eye_pass

U32 = jnp.uint32


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "n_paths", "max_bounces"),
    donate_argnames=("img",),
)
def vpl_pass(scene: Scene, img, pass_idx, seed, *, width, height, n_paths,
             max_bounces, clamp_dist):
    n = width * height
    pix = jnp.arange(n, dtype=U32)
    s_eye = mrng.make_sampler(pix, pass_idx, seed)
    pos, st, gatherable, _prim = eye_pass(scene, s_eye, width, height,
                                   max_delta_bounces=4)
    bp_eye = scene.bsdf_at(_fake_it(st))
    li = st["le"]

    # ---- direct illumination: one NEE sample per pixel -------------------
    s = st["sampler"]
    s, nee_blk = mrng.next_block4(s)
    ds = em.sample_direct(scene.emitters, scene.geom, st["p"],
                          nee_blk[..., 0], nee_blk[..., 1:3])
    frame = (st["ss"], st["ts"], st["ns"])
    wo_local = m.Frame.to_local(frame, ds.d)
    f = bsdf_eval(bp_eye, st["wi_local"], wo_local)
    occ = scene.occluded(st["p"], ds.d, EPSILON,
                         ds.dist * (1.0 - SHADOW_EPSILON))
    ok = gatherable & (ds.pdf > 0) & ~occ
    li = li + jnp.where(ok[..., None],
                        st["thr"] * ds.value * f / jnp.maximum(ds.pdf, 1e-20)[..., None],
                        0.0)

    # ---- VPL generation --------------------------------------------------
    vid = jnp.arange(n_paths, dtype=U32)
    s_v = mrng.make_sampler(vid, pass_idx, seed ^ U32(0xC0FFEE))
    p_v, pw_v, _wi_v, valid_v, surf = photon_trace(
        scene, s_v, n_paths, max_bounces, want_surface=True)
    bp_vpl = scene.bsdf_at(
        _fake_it(dict(p=p_v, ns=surf["ns"], ng=surf["ns"], ss=surf["ss"],
                      ts=surf["ts"], uv=surf["uv"], shape=surf["shape"],
                      wi_local=surf["wi_local"], active=valid_v)))
    K = p_v.shape[0]

    def body(k, acc):
        vp = p_v[k]
        vpow = pw_v[k]
        vok = valid_v[k]
        d = vp - st["p"]
        dist2 = jnp.sum(d * d, axis=-1)
        dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
        dirw = d / dist[..., None]
        # eye-side response (includes cos at the eye vertex)
        f_x = bsdf_eval(bp_eye, st["wi_local"], m.Frame.to_local(frame, dirw))
        # VPL-side response (includes cos at the VPL)
        fr_v = (surf["ss"][k], surf["ts"][k], surf["ns"][k])
        wo_v = m.Frame.to_local(
            (jnp.broadcast_to(fr_v[0], dirw.shape),
             jnp.broadcast_to(fr_v[1], dirw.shape),
             jnp.broadcast_to(fr_v[2], dirw.shape)), -dirw)
        bp_k = jax.tree_util.tree_map(lambda a: a[k][None], bp_vpl)
        f_v = bsdf_eval(
            jax.tree_util.tree_map(
                lambda a: jnp.broadcast_to(a, a.shape[:0] + (dirw.shape[0],) + a.shape[1:]),
                bp_k),
            jnp.broadcast_to(surf["wi_local"][k], dirw.shape), wo_v)
        # clamped geometry residual (vpl.cpp distance clamping)
        g = 1.0 / jnp.maximum(dist2, clamp_dist * clamp_dist)
        occ_v = scene.occluded(st["p"], dirw, EPSILON,
                               dist * (1.0 - SHADOW_EPSILON))
        contrib = st["thr"] * f_x * f_v * vpow * g[..., None]
        ok_v = gatherable & vok & ~occ_v
        return acc + jnp.where(ok_v[..., None], contrib, 0.0)

    indirect = jnp.zeros_like(li)
    if K > 0:
        indirect = jax.lax.fori_loop(0, K, body, indirect)
    # the K VPLs came from n_paths light paths: average per path
    li = li + indirect / n_paths
    li = jnp.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0)
    px = jnp.clip(pos[..., 0].astype(jnp.int32), 0, width - 1)
    py = jnp.clip(pos[..., 1].astype(jnp.int32), 0, height - 1)
    img = img.reshape(-1, 3).at[py * width + px].add(li).reshape(img.shape)
    return img


def render_vpl(scene: Scene, settings, spp: int | None = None) -> np.ndarray:
    """VPL render; each pass uses an independent VPL set + pixel jitter."""
    ip = settings.integrator_props
    W, H = settings.width, settings.height
    n_passes = spp if spp is not None else max(settings.spp // 4, 1)
    # a VPL at light-path depth b + eye connection = path length b + 2
    md = ip.get("max_depth", 5)
    max_bounces = (md if md > 0 else 5) - 2
    max_bounces = max(max_bounces, 1)
    n_paths = int(ip.get("vpl_count", 64))
    bsr = float(scene.emitters.bsphere_radius)
    clamp_dist = float(ip.get("clamping", 0.1)) * max(bsr, 1e-3)

    img = jnp.zeros((H, W, 3), Float)
    seed = jnp.uint32(settings.seed)
    for p in range(n_passes):
        img = vpl_pass(scene, img, jnp.uint32(p), seed, width=W, height=H,
                       n_paths=n_paths, max_bounces=max_bounces,
                       clamp_dist=jnp.asarray(clamp_dist, Float))
    out = np.asarray(img) / n_passes
    return out.astype(np.float32)


def _unused():  # keep namespace tidy for imports
    _ = (bsdf_pdf, mi_weight)
