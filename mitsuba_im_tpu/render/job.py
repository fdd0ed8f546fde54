"""Render orchestration: samples -> integrator -> film.

The wavefront analog of ``RenderJob``/``BlockedRenderProcess``
(``/root/reference/src/librender/renderjob.cpp:86``, ``renderproc.h:39``):
instead of spiral CPU tiles pulled from a scheduler, the whole image is a
flat wavefront; samples are processed in jit-compiled passes of one sample-
per-pixel each (bounding device memory), film accumulation is functional
(donated buffers), and the spp loop doubles as the progressive-refinement
hook for the interactive layer.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import Float, Int
from ..core import rng as mrng
from ..sampler import KIND_BY_NAME
from ..film.film import Film, make_film, splat, develop
from ..sensor.table import sample_ray
from ..integrators.path import PathConfig, path_li
from ..integrators.simple import direct_li, ao_li, field_li
from ..scene.build import RenderSettings
from ..scene.scene import Scene


# integrators rendered pass by pass into a film by ``render_film``; every
# other one has its own driver behind ``render``
FILM_INTEGRATORS = ("path", "volpath", "direct", "ao", "field", "motion")


def _integrator_fn(settings: RenderSettings):
    name = settings.integrator
    ip = settings.integrator_props
    if name in ("path", "volpath"):
        cfg = PathConfig(
            max_depth=ip.get("max_depth", -1),
            rr_depth=ip.get("rr_depth", 5),
            hide_emitters=ip.get("hide_emitters", False),
            strict_normals=ip.get("strict_normals", False),
            # forward-only rendering: checkpointing the bounce loop only
            # pays off under reverse-mode AD (diff/optimize keeps it on)
            remat=False,
        )
        if name == "volpath":
            from ..integrators.volpath import volpath_li

            return lambda scene, s, o, d, **kw: volpath_li(scene, s, o, d,
                                                           cfg)
        return lambda scene, s, o, d, **kw: path_li(scene, s, o, d, cfg,
                                                    **kw)
    if name == "direct":
        return lambda scene, s, o, d, **kw: direct_li(
            scene, s, o, d,
            emitter_samples=ip.get("emitter_samples", 1),
            bsdf_samples=ip.get("bsdf_samples", 1),
            hide_emitters=ip.get("hide_emitters", False),
        )
    if name == "ao":
        return lambda scene, s, o, d, **kw: ao_li(
            scene, s, o, d,
            shading_samples=ip.get("shading_samples", 1),
            ray_length=ip.get("ray_length", -1.0),
        )
    if name == "field":
        return lambda scene, s, o, d, **kw: field_li(scene, s, o, d, ip.get("field", "position"))
    if name == "motion":
        from ..integrators.simple import motion_li

        prev = ip.get("prev_to_world", None)
        if prev is None and ip.get("sensor_animation") is not None:
            anim = ip["sensor_animation"]  # core.track.AnimatedTransform
            prev = anim.eval(-ip.get("time_delta", 1.0 / 24.0)).m
        return lambda scene, s, o, d, **kw: motion_li(
            scene, s, o, d, prev_to_world=prev,
            width=settings.width, height=settings.height)
    if name == "adaptive":
        nested = dict(ip.get("nested", {"name": "path"}))
        sub = RenderSettings(integrator=nested.pop("name", "path"), integrator_props=nested)
        return _integrator_fn(sub)
    raise ValueError(f"integrator '{name}' not wired into the render job yet")


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "kind", "li_fn", "ftype", "radius"),
    donate_argnames=("film_data",),
)
def _render_pass(scene: Scene, film_data, sample_idx, seed, *, width, height,
                 spp, kind, li_fn, ftype, radius):
    """One sample-per-pixel pass over the full image (jitted, film donated)."""
    n = width * height
    pix = jnp.arange(n, dtype=jnp.uint32)
    sampler = mrng.make_sampler(pix, sample_idx, seed, kind=kind, spp=spp)

    sampler, blk0 = mrng.next_block4(sampler)
    jitter, u_lens = blk0[..., :2], blk0[..., 2:4]
    px = (pix % width).astype(Float)
    py = (pix // width).astype(Float)
    pos = jnp.stack([px, py], axis=-1) + jitter
    uv = pos / jnp.asarray([width, height], Float)

    if scene.motion is not None:
        # stratified shutter time per pass (golden-ratio sequence)
        u_t = (sample_idx * jnp.uint32(2654435769)).astype(Float) / 4294967296.0
        scene = scene.with_time(scene.sensor.shutter_open
                                + scene.sensor.shutter_time * u_t)
    o, d, w_sensor = sample_ray(scene.sensor, uv, u_lens)
    kw = {}
    if scene.textures.has_mip:
        # primary-ray differentials for MIP/aniso texture filtering
        _, d_px, _ = sample_ray(
            scene.sensor, uv + jnp.asarray([1.0 / width, 0.0], Float), u_lens)
        _, d_py, _ = sample_ray(
            scene.sensor, uv + jnp.asarray([0.0, 1.0 / height], Float), u_lens)
        kw = dict(dddx=d_px - d, dddy=d_py - d)
    li, _ = li_fn(scene, sampler, o, d, **kw)
    li = jnp.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0) * w_sensor[..., None]

    film = Film(data=film_data, width=width, height=height, ftype=ftype, radius=radius)
    film = splat(film, pos, li)
    return film.data


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "band_rows", "margin", "spp", "kind",
                     "li_fn", "ftype", "radius"),
    donate_argnames=("band_data",),
)
def _render_band(scene: Scene, band_data, sample_idx, seed, row0, *, width,
                 height, band_rows, margin, spp, kind, li_fn, ftype, radius):
    """One pass over rows [row0, row0+band_rows) of the full film, splatting
    into a (band_rows + 2*margin, W, 4) band buffer (tiledhdrfilm path)."""
    n = width * band_rows
    lidx = jnp.arange(n, dtype=jnp.uint32)
    pix = row0.astype(jnp.uint32) * width + lidx
    in_img = pix < jnp.uint32(width * height)
    sampler = mrng.make_sampler(pix, sample_idx, seed, kind=kind, spp=spp)
    sampler, blk0 = mrng.next_block4(sampler)
    jitter, u_lens = blk0[..., :2], blk0[..., 2:4]
    px = (pix % width).astype(Float)
    py = (pix // width).astype(Float)
    pos = jnp.stack([px, py], axis=-1) + jitter
    uv = pos / jnp.asarray([width, height], Float)
    if scene.motion is not None:
        u_t = (sample_idx * jnp.uint32(2654435769)).astype(Float) / 4294967296.0
        scene = scene.with_time(scene.sensor.shutter_open
                                + scene.sensor.shutter_time * u_t)
    o, d, w_sensor = sample_ray(scene.sensor, uv, u_lens)
    li, _ = li_fn(scene, sampler, o, d)
    li = jnp.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0) * w_sensor[..., None]
    band_pos = pos - jnp.asarray([0.0, 1.0], Float) * (
        row0.astype(Float) - margin)
    film = Film(data=band_data, width=width, height=band_data.shape[0],
                ftype=ftype, radius=radius)
    film = splat(film, band_pos, li, active=in_img)
    return film.data


def render(scene: Scene, settings: RenderSettings,
           spp: int | None = None, progress_cb=None) -> np.ndarray:
    """Full render -> (H, W, 3) float32 numpy image."""
    if settings.integrator == "ptracer":
        return render_ptracer(scene, settings, spp=spp)
    if settings.integrator == "pssmlt":
        from ..integrators.pssmlt import render_pssmlt

        return render_pssmlt(scene, settings, spp=spp, progress_cb=progress_cb)
    if settings.integrator == "mlt":
        from ..integrators.mlt import render_mlt

        return render_mlt(scene, settings, spp=spp, progress_cb=progress_cb)
    if settings.integrator == "erpt":
        from ..integrators.erpt import render_erpt

        return render_erpt(scene, settings, spp=spp)
    if settings.integrator in ("sppm", "ppm"):
        from ..integrators.sppm import render_sppm

        return render_sppm(scene, settings, spp=spp, progress_cb=progress_cb)
    if settings.integrator == "bdpt":
        from ..integrators.bdpt import render_bdpt

        return render_bdpt(scene, settings, spp=spp, progress_cb=progress_cb)
    if settings.integrator == "vpl":
        from ..integrators.vpl import render_vpl

        return render_vpl(scene, settings, spp=spp)
    if settings.integrator == "adaptive":
        from ..integrators.adaptive import render_adaptive

        return render_adaptive(scene, settings, spp=spp)
    if settings.integrator == "multichannel":
        from ..integrators.multichannel import render_multichannel

        return render_multichannel(scene, settings, spp=spp)
    if settings.integrator == "irrcache":
        from ..integrators.irrcache import render_irrcache

        return render_irrcache(scene, settings, spp=spp)
    film = render_film(scene, settings, spp=spp, progress_cb=progress_cb)
    return np.asarray(develop(film))


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "n_particles", "cfg", "kind"),
    donate_argnames=("film_data",),
)
def _ptracer_pass(scene: Scene, film_data, sample_idx, seed, *, width, height,
                  n_particles, cfg, kind):
    from ..integrators.ptracer import ptracer_splats
    from ..film.film import F_BOX

    pid = jnp.arange(n_particles, dtype=jnp.uint32)
    sampler = mrng.make_sampler(pid, sample_idx, seed, kind=kind)
    uvs, vals = ptracer_splats(scene, sampler, n_particles, cfg)
    pos = uvs.reshape(-1, 2) * jnp.asarray([width, height], Float)
    val = vals.reshape(-1, 3)
    film = Film(data=film_data, width=width, height=height, ftype=F_BOX, radius=0.5)
    film = splat(film, pos, val, active=jnp.sum(jnp.abs(val), axis=-1) > 0)
    return film.data


def render_ptracer(scene: Scene, settings: RenderSettings, spp: int | None = None):
    """Light-traced image: N = W*H*spp particles, image-plane normalized."""
    from ..integrators.path import PathConfig

    spp = spp if spp is not None else settings.spp
    ip = settings.integrator_props
    cfg = PathConfig(max_depth=ip.get("max_depth", -1),
                     rr_depth=ip.get("rr_depth", 5),
                     depth_budget=min(ip.get("depth_budget", 8), 12))
    W, H = settings.width, settings.height
    n_particles = W * H
    kind = KIND_BY_NAME.get(settings.sampler, mrng.INDEPENDENT)
    data = jnp.zeros((H, W, 4), Float)
    for s in range(spp):
        data = _ptracer_pass(
            scene, data, jnp.uint32(s), jnp.uint32(settings.seed),
            width=W, height=H, n_particles=n_particles, cfg=cfg, kind=kind,
        )
    total = spp * n_particles
    return np.asarray(data[..., :3]) * (W * H / total)


def render_film(scene: Scene, settings: RenderSettings, spp: int | None = None,
                film: Film | None = None, sample_offset: int = 0,
                progress_cb=None) -> Film:
    spp = spp if spp is not None else settings.spp
    kind = KIND_BY_NAME.get(settings.sampler, mrng.INDEPENDENT)
    li_fn = _integrator_fn(settings)
    if film is None:
        film = make_film(settings.width, settings.height, settings.rfilter,
                         settings.rfilter_radius)
    data = film.data
    for s in range(spp):
        data = _render_pass(
            scene, data, jnp.uint32(sample_offset + s), jnp.uint32(settings.seed),
            width=settings.width, height=settings.height, spp=spp, kind=kind,
            li_fn=li_fn, ftype=film.ftype, radius=film.radius,
        )
        if progress_cb is not None:
            progress_cb(s + 1, spp, Film(data=data, width=film.width,
                                         height=film.height, ftype=film.ftype,
                                         radius=film.radius))
    from ..core import statistics as stats

    n = settings.width * settings.height
    stats.record("Render", "Passes", spp)
    stats.record("Render", "Camera rays generated", n * spp)
    stats.record("Render", "Film samples splatted", n * spp)
    return Film(data=data, width=film.width, height=film.height,
                ftype=film.ftype, radius=film.radius)


def lower_render_pass(scene: Scene, settings: RenderSettings):
    """``render_film``'s jitted one-spp pass, lowered for this scene; its
    ``compile()`` gives the memory analysis and the optimized HLO, and is
    called as ``compiled(scene, film_data, sample_idx, seed)``."""
    film = make_film(settings.width, settings.height, settings.rfilter,
                     settings.rfilter_radius)
    return _render_pass.lower(
        scene, film.data, jnp.uint32(0), jnp.uint32(settings.seed),
        width=settings.width, height=settings.height, spp=settings.spp,
        kind=KIND_BY_NAME.get(settings.sampler, mrng.INDEPENDENT),
        li_fn=_integrator_fn(settings), ftype=film.ftype, radius=film.radius)


def tonemap_ldr(img: np.ndarray, settings: RenderSettings) -> np.ndarray:
    """ldrfilm develop chain (films/ldrfilm.cpp): gamma or Reinhard."""
    img = np.asarray(img, np.float32) * (2.0 ** settings.exposure)
    if settings.tonemap == "reinhard":
        # numpy Rec.709 luminance (keep the tonemap chain jax-free so the
        # mtsutil utilities never touch the device)
        lum = (img[..., 0] * 0.212671 + img[..., 1] * 0.715160
               + img[..., 2] * 0.072169)
        avg = np.exp(np.mean(np.log(np.maximum(lum, 1e-6))))
        scaled = img * (settings.key / max(avg, 1e-9))
        img = scaled / (1.0 + scaled)
    g = settings.gamma
    if g <= 0:
        c = np.clip(img, 0, 1)
        img = np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)
    else:
        img = np.clip(img, 0, 1) ** (1.0 / g)
    return np.clip(img, 0.0, 1.0)


def save_render(path: str, img: np.ndarray, settings: RenderSettings,
                metadata: dict | None = None) -> None:
    from ..io import bitmap as bmp
    import os

    ext = os.path.splitext(path)[1].lower()
    aux = getattr(settings, "aux_channels", None)
    if aux is not None and ext == ".exr":
        from ..io.exr import write_exr

        channel_names, stack = aux
        write_exr(path, stack, metadata=metadata, channel_names=channel_names)
        return
    if ext in (".png", ".jpg", ".ppm"):
        img = tonemap_ldr(img, settings)
    bmp.save(path, img, metadata=metadata)
