"""Film accumulation with reconstruction-filtered splatting.

Reference: ``include/mitsuba/render/film.h:37``, the filtered ImageBlock
splat (``imageblock.h:161-221``), the fork's atomic shared-framebuffer splat
(``imageblock.h:222``), and the rfilter plugins (``src/rfilters/``).

Wavefront design: the film is an ``(H, W, 4)`` array (RGB + filter weight).  Each
sample splats to a static (2r)x(2r) neighborhood via scatter-add — the
functional analog of the 128-bit-CAS atomic splat; XLA lowers it to a sorted
segment-sum.  Box-filter samples hit exactly one pixel (fast path).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int

F_BOX = 0
F_TENT = 1
F_GAUSSIAN = 2
F_MITCHELL = 3
F_CATMULLROM = 4
F_LANCZOS = 5

FILTER_NAMES = {
    "box": F_BOX, "tent": F_TENT, "gaussian": F_GAUSSIAN,
    "mitchell": F_MITCHELL, "catmullrom": F_CATMULLROM, "lanczos": F_LANCZOS,
}

# default radii per reference plugins (src/rfilters/*.cpp)
DEFAULT_RADIUS = {
    F_BOX: 0.5, F_TENT: 1.0, F_GAUSSIAN: 2.0, F_MITCHELL: 2.0,
    F_CATMULLROM: 2.0, F_LANCZOS: 3.0,
}


def filter_eval(ftype: int, x: jax.Array, radius: float) -> jax.Array:
    """1D filter kernel (all reference filters are separable here; the
    gaussian matches the reference's truncated stddev-0.5-scaled form)."""
    ax = jnp.abs(x)
    if ftype == F_BOX:
        return jnp.where(ax <= radius, 1.0, 0.0)
    if ftype == F_TENT:
        return jnp.maximum(0.0, 1.0 - ax / radius)
    if ftype == F_GAUSSIAN:
        stddev = radius / 4.0
        alpha = -1.0 / (2.0 * stddev * stddev)
        return jnp.maximum(0.0, jnp.exp(alpha * ax * ax) - jnp.exp(alpha * radius * radius))
    if ftype in (F_MITCHELL, F_CATMULLROM):
        if ftype == F_MITCHELL:
            B = C = 1.0 / 3.0
        else:
            B, C = 0.0, 0.5
        t = ax * 2.0 / radius  # normalized to [0, 2]
        t2, t3 = t * t, t * t * t
        inner = (
            (12 - 9 * B - 6 * C) * t3 + (-18 + 12 * B + 6 * C) * t2 + (6 - 2 * B)
        ) * (1.0 / 6.0)
        outer = (
            (-B - 6 * C) * t3 + (6 * B + 30 * C) * t2 + (-12 * B - 48 * C) * t
            + (8 * B + 24 * C)
        ) * (1.0 / 6.0)
        return jnp.where(t < 1.0, inner, jnp.where(t < 2.0, outer, 0.0))
    if ftype == F_LANCZOS:
        tau = 3.0
        t = ax * tau / radius
        pit = jnp.pi * jnp.where(ax < 1e-6, 1.0, t)
        sinc = jnp.where(ax < 1e-6, 1.0, jnp.sin(pit) / pit)
        pitt = pit / tau
        window = jnp.where(ax < 1e-6, 1.0, jnp.sin(pitt) / pitt)
        return jnp.where(t < tau, sinc * window, 0.0)
    raise ValueError(ftype)


@pytree_dataclass
class Film:
    data: jax.Array  # (H, W, 4): rgb premultiplied by filter weight + weight
    width: int = static_field(default=0)
    height: int = static_field(default=0)
    ftype: int = static_field(default=F_GAUSSIAN)
    radius: float = static_field(default=2.0)

    @property
    def spp_equivalent(self):
        return self.data[..., 3]


def make_film(width: int, height: int, ftype: int = F_GAUSSIAN,
              radius: float | None = None) -> Film:
    if radius is None:
        radius = DEFAULT_RADIUS[ftype]
    return Film(
        data=jnp.zeros((height, width, 4), Float),
        width=width, height=height, ftype=ftype, radius=float(radius),
    )


def splat(film: Film, pos: jax.Array, value: jax.Array,
          active: jax.Array | None = None) -> Film:
    """Accumulate samples into the film.

    pos: (N, 2) continuous film coordinates in pixels (x, y);
    value: (N, 3) radiance; active: (N,) mask.
    """
    x, y = pos[..., 0], pos[..., 1]
    ones = jnp.ones(x.shape, Float)
    if active is None:
        active = jnp.ones(x.shape, bool)
    value = jnp.where(active[..., None], value, 0.0)
    wsample = jnp.where(active, ones, 0.0)

    H, W = film.height, film.width
    if film.ftype == F_BOX and film.radius <= 0.5:
        px = jnp.clip(x.astype(Int), 0, W - 1)
        py = jnp.clip(y.astype(Int), 0, H - 1)
        idx = py * W + px
        flat = film.data.reshape(-1, 4)
        upd = jnp.concatenate([value, wsample[..., None]], axis=-1)
        flat = flat.at[idx].add(upd, mode="drop")
        return film.replace(data=flat.reshape(H, W, 4))

    r = film.radius
    supp = int(np.ceil(2 * r))  # number of taps per axis
    x0 = jnp.floor(x - r + 0.5).astype(Int)
    y0 = jnp.floor(y - r + 0.5).astype(Int)
    flat = film.data.reshape(-1, 4)
    for dy in range(supp):
        for dx in range(supp):
            px = x0 + dx
            py = y0 + dy
            fw = filter_eval(film.ftype, px.astype(Float) + 0.5 - x, r) * \
                 filter_eval(film.ftype, py.astype(Float) + 0.5 - y, r)
            inside = (px >= 0) & (px < W) & (py >= 0) & (py < H) & active
            w = jnp.where(inside, fw, 0.0)
            idx = jnp.where(inside, py * W + px, 0)
            upd = jnp.concatenate(
                [value * w[..., None], (wsample * w)[..., None]], axis=-1
            )
            upd = jnp.where(inside[..., None], upd, 0.0)
            flat = flat.at[idx].add(upd, mode="drop")
    return film.replace(data=flat.reshape(H, W, 4))


def develop(film: Film) -> jax.Array:
    """Weighted average -> (H, W, 3) radiance image (Film::develop)."""
    w = film.data[..., 3:4]
    return jnp.where(w > 0, film.data[..., :3] / jnp.maximum(w, 1e-12), 0.0)


def merge(films: list[Film]) -> Film:
    """Combine per-worker/per-device films (StackedPreview composite analog)."""
    out = films[0]
    for f in films[1:]:
        out = out.replace(data=out.data + f.data)
    return out
