"""Texture system: constant / bitmap (atlas) / procedural, SoA dispatch.

Reference surface: ``/root/reference/src/textures/`` (bitmap w/ MIP+EWA,
checkerboard, gridtexture, scale, wireframe, curvature, vertexcolors) and
``include/mitsuba/render/mipmap.h``.  Wavefront design: all bitmap textures are
packed into one flat device atlas; evaluation is a bilinear 4-gather; procedural
types evaluate inline.  Dispatch is by integer type code with only the types
present in the scene compiled in (static ``used_types``).

**MIP + anisotropic filtering**: every bitmap gets a box-filtered MIP
pyramid appended to the atlas (per-level offsets in ``mip_offset``).  When
the caller supplies screen-space UV derivatives (ray differentials,
``include/mitsuba/render/integrator2.h:136`` PixelDifferential analog),
lookups are trilinear with an anisotropic extension: the reference's EWA
(``mipmap.h:862``) walks a data-dependent ellipse — hostile to static
shapes — so here the ellipse is integrated by ``ANISO_TAPS`` fixed
Gaussian-weighted trilinear taps along its major axis (the hardware-aniso
formulation), which matches EWA up to anisotropy ``ANISO_TAPS`` with fully
static control flow.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int, INVALID

TEX_CONST = 0
TEX_BITMAP = 1
TEX_CHECKER = 2
TEX_GRID = 3
TEX_SCALE = 4  # value0 * nested
TEX_WIREFRAME = 5
TEX_VERTEXCOLORS = 6
TEX_CURVATURE = 7

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2

MAX_MIP = 16     # level offsets per record (supports up to 32768^2 textures)
ANISO_TAPS = 4   # fixed trilinear probes along the footprint's major axis


@pytree_dataclass
class TextureTable:
    type: jax.Array  # (X,) int32
    value0: jax.Array  # (X, 3) const color / checker c0 / scale factor
    value1: jax.Array  # (X, 3) checker c1 / grid line color
    offset: jax.Array  # (X,) int32 start into atlas (bitmap)
    width: jax.Array  # (X,) int32
    height: jax.Array  # (X,) int32
    uvscale: jax.Array  # (X, 2)
    uvoffset: jax.Array  # (X, 2)
    param0: jax.Array  # (X,) scalar (grid lineWidth etc.)
    wrap: jax.Array  # (X,) int32
    nested: jax.Array  # (X,) int32 (scale wrapper)
    gamma_srgb: jax.Array  # (X,) int32 (bitmap stored sRGB -> delinearize)
    atlas: jax.Array  # (P, 3) all bitmap texels, row-major concatenated
    mip_offset: jax.Array  # (X, MAX_MIP) atlas start of each MIP level
    n_levels: jax.Array  # (X,) pyramid depth (1 = base only)
    used_types: tuple = static_field(default=(TEX_CONST,))
    has_mip: bool = static_field(default=False)


class TextureBuilder:
    """Host-side accumulator producing a TextureTable."""

    def __init__(self):
        self.records: list[dict] = []
        self.atlas_parts: list[np.ndarray] = []
        self.atlas_size = 0

    def add(self, **kw) -> int:
        rec = dict(
            type=TEX_CONST,
            value0=np.zeros(3), value1=np.zeros(3),
            offset=0, width=0, height=0,
            uvscale=np.ones(2), uvoffset=np.zeros(2),
            param0=0.0, wrap=WRAP_REPEAT, nested=INVALID, gamma_srgb=0,
            mip_offset=np.zeros(MAX_MIP, np.int64), n_levels=1,
        )
        rec.update(kw)
        self.records.append(rec)
        return len(self.records) - 1

    def add_constant(self, rgb) -> int:
        return self.add(type=TEX_CONST, value0=np.asarray(rgb, np.float64))

    def add_bitmap(self, pixels: np.ndarray, uvscale=(1, 1), uvoffset=(0, 0),
                   wrap=WRAP_REPEAT) -> int:
        """pixels: (H, W, 3) float32 linear RGB.  Builds the MIP pyramid
        (2x2 box, ceil-halved for odd sizes) and appends every level."""
        h, w = pixels.shape[:2]
        img = np.asarray(pixels, np.float32)
        mip_off = np.zeros(MAX_MIP, np.int64)
        n_levels = 0
        off = self.atlas_size
        while True:
            mip_off[n_levels] = self.atlas_size
            flat = img.reshape(-1, 3)
            self.atlas_parts.append(flat)
            self.atlas_size += len(flat)
            n_levels += 1
            lh, lw = img.shape[:2]
            if (lh <= 1 and lw <= 1) or n_levels >= MAX_MIP:
                break
            # pad to even, then 2x2 box (edge-replicated for odd sizes)
            ph, pw = lh + (lh & 1), lw + (lw & 1)
            pad = np.pad(img, ((0, ph - lh), (0, pw - lw), (0, 0)),
                         mode="edge")
            img = 0.25 * (pad[0::2, 0::2] + pad[1::2, 0::2]
                          + pad[0::2, 1::2] + pad[1::2, 1::2])
        mip_off[n_levels:] = mip_off[n_levels - 1]
        return self.add(
            type=TEX_BITMAP, offset=off, width=w, height=h,
            uvscale=np.asarray(uvscale, np.float64),
            uvoffset=np.asarray(uvoffset, np.float64), wrap=wrap,
            mip_offset=mip_off, n_levels=n_levels,
        )

    def build(self) -> TextureTable:
        recs = self.records or [dict(
            type=TEX_CONST, value0=np.zeros(3), value1=np.zeros(3), offset=0,
            width=0, height=0, uvscale=np.ones(2), uvoffset=np.zeros(2),
            param0=0.0, wrap=0, nested=INVALID, gamma_srgb=0,
            mip_offset=np.zeros(MAX_MIP, np.int64), n_levels=1,
        )]
        atlas = (
            np.concatenate(self.atlas_parts, axis=0)
            if self.atlas_parts
            else np.zeros((1, 3), np.float32)
        )
        g = lambda k, dt: jnp.asarray(np.stack([np.asarray(r[k]) for r in recs]), dt)
        return TextureTable(
            type=g("type", Int), value0=g("value0", Float), value1=g("value1", Float),
            offset=g("offset", Int), width=g("width", Int), height=g("height", Int),
            uvscale=g("uvscale", Float), uvoffset=g("uvoffset", Float),
            param0=g("param0", Float), wrap=g("wrap", Int), nested=g("nested", Int),
            gamma_srgb=g("gamma_srgb", Int),
            atlas=jnp.asarray(atlas, Float),
            mip_offset=g("mip_offset", Int),
            n_levels=g("n_levels", Int),
            used_types=tuple(sorted({int(r["type"]) for r in recs})),
            has_mip=any(int(r["n_levels"]) > 1 for r in recs),
        )


def _wrap_coord(x, n, wrap_mode):
    """Integer texel coordinate wrapping, vectorized over modes."""
    n = jnp.maximum(n, 1)
    rep = jnp.mod(x, n)
    clmp = jnp.clip(x, 0, n - 1)
    period = 2 * n
    mx = jnp.mod(x, period)
    mir = jnp.where(mx >= n, period - 1 - mx, mx)
    return jnp.where(wrap_mode == WRAP_REPEAT, rep,
                     jnp.where(wrap_mode == WRAP_CLAMP, clmp, mir))


def _bilinear_level_v(atlas, offl, wl, hl, wrap, us, vs):
    """Bilinear 4-gather at one (per-lane) MIP level; flat SoA arrays."""
    from ..core import v3 as v

    wf = wl.astype(Float)
    hf = hl.astype(Float)
    fx = us * wf - 0.5
    fy = vs * hf - 0.5
    x0 = jnp.floor(fx).astype(Int)
    y0 = jnp.floor(fy).astype(Int)
    dx = fx - x0.astype(Float)
    dy = fy - y0.astype(Float)

    def texel(xi, yi):
        xi = _wrap_coord(xi, wl, wrap)
        yi = _wrap_coord(yi, hl, wrap)
        idx = offl + yi * jnp.maximum(wl, 1) + xi
        idx = jnp.clip(idx, 0, atlas.shape[0] - 1)
        return v.V3.from_array(atlas[idx])

    return (
        texel(x0, y0) * ((1 - dx) * (1 - dy))
        + texel(x0 + 1, y0) * (dx * (1 - dy))
        + texel(x0, y0 + 1) * ((1 - dx) * dy)
        + texel(x0 + 1, y0 + 1) * (dx * dy)
    )


def _level_dims(w, h, lvl):
    """ceil(w / 2^lvl) — matches the builder's iterated ceil-halving."""
    sh = jnp.left_shift(jnp.ones_like(lvl), lvl)
    wl = jnp.maximum((w + sh - 1) >> lvl, 1)
    hl = jnp.maximum((h + sh - 1) >> lvl, 1)
    return wl, hl


def _filtered_bitmap_v(table, tid, w, h, wrap, us, vs, su, sv, duv):
    """Trilinear + fixed-tap anisotropic MIP lookup (EWA redesign)."""
    from ..core import v3 as v

    dudx, dvdx, dudy, dvdy = duv
    wf = jnp.maximum(w, 1).astype(Float)
    hf = jnp.maximum(h, 1).astype(Float)
    # footprint axes in texel space
    ax_u = dudx * su * wf
    ax_v = dvdx * sv * hf
    ay_u = dudy * su * wf
    ay_v = dvdy * sv * hf
    lx2 = ax_u * ax_u + ax_v * ax_v
    ly2 = ay_u * ay_u + ay_v * ay_v
    major2 = jnp.maximum(lx2, ly2)
    minor2 = jnp.minimum(lx2, ly2)
    # cap anisotropy at the tap count (probes cover the rest of the major axis)
    minor2 = jnp.maximum(minor2, major2 / (ANISO_TAPS * ANISO_TAPS))
    lod = jnp.maximum(0.5 * jnp.log2(jnp.maximum(minor2, 1.0)), 0.0)
    nl = table.n_levels[tid] if table.n_levels.shape[0] > v.SELECT_MAX \
        else v.gather_col(table.n_levels, tid)
    lmax = jnp.maximum(nl - 1, 0)
    l0 = jnp.minimum(jnp.floor(lod).astype(Int), lmax)
    l1 = jnp.minimum(l0 + 1, lmax)
    fr = jnp.clip(lod - l0.astype(Float), 0.0, 1.0)

    mip_flat = table.mip_offset.reshape(-1)
    off0 = mip_flat[tid * MAX_MIP + l0]
    off1 = mip_flat[tid * MAX_MIP + l1]
    w0, h0 = _level_dims(w, h, l0)
    w1, h1 = _level_dims(w, h, l1)

    # major-axis direction in (scaled) uv space
    x_major = lx2 >= ly2
    mu = jnp.where(x_major, dudx, dudy) * su
    mv = jnp.where(x_major, dvdx, dvdy) * sv

    acc = v.zeros(us.shape)
    wsum = 0.0
    for i in range(ANISO_TAPS):
        t = (i + 0.5) / ANISO_TAPS - 0.5
        wgt = float(np.exp(-2.0 * (2.0 * t) ** 2))
        ui = us + mu * t
        vi = vs + mv * t
        c0 = _bilinear_level_v(table.atlas, off0, w0, h0, wrap, ui, vi)
        c1 = _bilinear_level_v(table.atlas, off1, w1, h1, wrap, ui, vi)
        acc = acc + v.lerp(c0, c1, fr) * wgt
        wsum += wgt
    return acc / wsum


def eval_texture_v(table: TextureTable, tex_id: jax.Array, uv_u: jax.Array,
                   uv_v: jax.Array, const_rgb=None, duv=None):
    """Component-SoA texture evaluation -> V3.

    Same dispatch as :func:`eval_texture` but every intermediate is a flat
    (N,) array (full tile density); table columns resolve through fused
    select chains for small tables.  ``duv`` (du/dx, dv/dx, du/dy, dv/dy
    flat arrays) switches bitmaps to the MIP/anisotropic filter.
    """
    from ..core import v3 as v

    tid = jnp.where(tex_id == INVALID, 0, tex_id)
    X = table.type.shape[0]
    small = X <= v.SELECT_MAX
    if small:
        gc = lambda col: v.gather_col(col, tid)
        g3 = lambda tab: v.gather_v3(tab, tid)
        g2 = lambda tab: (v.gather_col(tab[:, 0], tid),
                          v.gather_col(tab[:, 1], tid))
    else:
        gc = lambda col: col[tid]
        g3 = lambda tab: v.V3.from_array(tab[tid])
        g2 = lambda tab: (tab[tid][..., 0], tab[tid][..., 1])

    ttype = gc(table.type)
    out = v.zeros(uv_u.shape)
    su, sv = g2(table.uvscale)
    ou, ov = g2(table.uvoffset)
    us = uv_u * su + ou
    vs = uv_v * sv + ov

    if TEX_CONST in table.used_types:
        out = v.where(ttype == TEX_CONST, g3(table.value0), out)

    if TEX_BITMAP in table.used_types:
        w = gc(table.width)
        h = gc(table.height)
        wrap = gc(table.wrap)
        off = gc(table.offset)
        if duv is not None and table.has_mip:
            c = _filtered_bitmap_v(table, tid, w, h, wrap, us, vs, su, sv,
                                   duv)
        else:
            c = _bilinear_level_v(table.atlas, off, jnp.maximum(w, 1),
                                  jnp.maximum(h, 1), wrap, us, vs)
        out = v.where(ttype == TEX_BITMAP, c, out)

    if TEX_CHECKER in table.used_types:
        xi = jnp.floor(us * 2.0).astype(Int)
        yi = jnp.floor(vs * 2.0).astype(Int)
        even = jnp.mod(xi + yi, 2) == 0
        c = v.where(even, g3(table.value0), g3(table.value1))
        out = v.where(ttype == TEX_CHECKER, c, out)

    if TEX_GRID in table.used_types:
        lw = gc(table.param0)
        fx = us - jnp.floor(us)
        fy = vs - jnp.floor(vs)
        on_line = (fx < lw) | (fx > 1 - lw) | (fy < lw) | (fy > 1 - lw)
        c = v.where(on_line, g3(table.value1), g3(table.value0))
        out = v.where(ttype == TEX_GRID, c, out)

    if TEX_SCALE in table.used_types:
        nested = gc(table.nested)
        nested = jnp.where(nested == INVALID, 0, nested)
        base = eval_texture_v(
            table.replace(used_types=tuple(
                t for t in table.used_types if t != TEX_SCALE)),
            nested, uv_u, uv_v, None, duv,
        )
        out = v.where(ttype == TEX_SCALE, base * g3(table.value0), out)

    if const_rgb is not None:
        out = v.where(tex_id == INVALID, const_rgb, out)
    return out


def eval_texture(table: TextureTable, tex_id: jax.Array, uv: jax.Array,
                 const_rgb: jax.Array | None = None) -> jax.Array:
    """Evaluate textures per lane.

    tex_id: (...,) int32; INVALID lanes return ``const_rgb`` (or zeros).
    uv: (..., 2).
    """
    from ..core.gather import RowBundle

    tid = jnp.where(tex_id == INVALID, 0, tex_id)
    tb = (
        RowBundle()
        .add("type", table.type).add("value0", table.value0)
        .add("value1", table.value1).add("offset", table.offset)
        .add("width", table.width).add("height", table.height)
        .add("uvscale", table.uvscale).add("uvoffset", table.uvoffset)
        .add("param0", table.param0).add("wrap", table.wrap)
        .add("nested", table.nested)
    ).lookup(tid)
    ttype = tb["type"]
    out = jnp.zeros(uv.shape[:-1] + (3,), Float)

    uvs = uv * tb["uvscale"] + tb["uvoffset"]

    if TEX_CONST in table.used_types:
        out = jnp.where((ttype == TEX_CONST)[..., None], tb["value0"], out)

    if TEX_BITMAP in table.used_types:
        w = tb["width"]
        h = tb["height"]
        wrap = tb["wrap"]
        fx = uvs[..., 0] * w.astype(Float) - 0.5
        fy = uvs[..., 1] * h.astype(Float) - 0.5
        x0 = jnp.floor(fx).astype(Int)
        y0 = jnp.floor(fy).astype(Int)
        dx = fx - x0.astype(Float)
        dy = fy - y0.astype(Float)

        def texel(xi, yi):
            xi = _wrap_coord(xi, w, wrap)
            yi = _wrap_coord(yi, h, wrap)
            idx = tb["offset"] + yi * jnp.maximum(w, 1) + xi
            idx = jnp.clip(idx, 0, table.atlas.shape[0] - 1)
            return table.atlas[idx]

        c = (
            texel(x0, y0) * ((1 - dx) * (1 - dy))[..., None]
            + texel(x0 + 1, y0) * (dx * (1 - dy))[..., None]
            + texel(x0, y0 + 1) * ((1 - dx) * dy)[..., None]
            + texel(x0 + 1, y0 + 1) * (dx * dy)[..., None]
        )
        out = jnp.where((ttype == TEX_BITMAP)[..., None], c, out)

    if TEX_CHECKER in table.used_types:
        xi = jnp.floor(uvs[..., 0] * 2.0).astype(Int)
        yi = jnp.floor(uvs[..., 1] * 2.0).astype(Int)
        even = jnp.mod(xi + yi, 2) == 0
        c = jnp.where(even[..., None], tb["value0"], tb["value1"])
        out = jnp.where((ttype == TEX_CHECKER)[..., None], c, out)

    if TEX_GRID in table.used_types:
        lw = tb["param0"]
        fx = uvs[..., 0] - jnp.floor(uvs[..., 0])
        fy = uvs[..., 1] - jnp.floor(uvs[..., 1])
        on_line = (
            (fx < lw) | (fx > 1 - lw) | (fy < lw) | (fy > 1 - lw)
        )
        c = jnp.where(on_line[..., None], tb["value1"], tb["value0"])
        out = jnp.where((ttype == TEX_GRID)[..., None], c, out)

    if TEX_SCALE in table.used_types:
        nested = jnp.where(tb["nested"] == INVALID, 0, tb["nested"])
        # one level of nesting: evaluate nested as const/bitmap inline
        base = eval_texture(
            table.replace(used_types=tuple(t for t in table.used_types if t != TEX_SCALE)),
            nested, uv, None,
        )
        out = jnp.where((ttype == TEX_SCALE)[..., None], base * tb["value0"], out)

    if const_rgb is not None:
        out = jnp.where((tex_id == INVALID)[..., None], const_rgb, out)
    return out
