"""Texture plugin factories (``/root/reference/src/textures/``).

Factories return texture *ids* into the scene's TextureBuilder (ctx).
"""
from __future__ import annotations

import numpy as np

from ..core.registry import register
from ..core.properties import Properties
from . import texture as tx
from .texture import *  # noqa: F401,F403


def _uv(props: Properties):
    return (
        (props.get_float("uscale", 1.0), props.get_float("vscale", 1.0)),
        (props.get_float("uoffset", 0.0), props.get_float("voffset", 0.0)),
    )


@register("texture", "bitmap")
def _bitmap(props: Properties, ctx=None):
    from ..io import bitmap as bmp

    path = props.get_string("filename")
    if ctx is not None and hasattr(ctx, "resolve_path"):
        path = ctx.resolve_path(path)
    gamma = props.get_float("gamma", -1.0)
    pixels = bmp.load(path, gamma_correct=(gamma != 1.0))[..., :3]
    wrap = {"repeat": tx.WRAP_REPEAT, "clamp": tx.WRAP_CLAMP,
            "mirror": tx.WRAP_MIRROR, "zero": tx.WRAP_CLAMP,
            "one": tx.WRAP_CLAMP}[props.get_string("wrapMode", "repeat")]
    props.get_string("filterType", "ewa")
    uvs, uvo = _uv(props)
    if ctx is None:
        return -1
    return ctx.textures.add_bitmap(pixels, uvscale=uvs, uvoffset=uvo, wrap=wrap)


@register("texture", "checkerboard")
def _checker(props: Properties, ctx=None):
    c0 = props.get_spectrum("color0", np.full(3, 0.4))
    c1 = props.get_spectrum("color1", np.full(3, 0.2))
    uvs, uvo = _uv(props)
    if ctx is None:
        return -1
    return ctx.textures.add(
        type=tx.TEX_CHECKER, value0=c0, value1=c1,
        uvscale=np.asarray(uvs), uvoffset=np.asarray(uvo),
    )


@register("texture", "gridtexture")
def _grid(props: Properties, ctx=None):
    c0 = props.get_spectrum("color0", np.full(3, 0.2))
    c1 = props.get_spectrum("color1", np.full(3, 0.4))
    lw = props.get_float("lineWidth", 0.01)
    uvs, uvo = _uv(props)
    if ctx is None:
        return -1
    return ctx.textures.add(
        type=tx.TEX_GRID, value0=c1, value1=c0, param0=lw,
        uvscale=np.asarray(uvs), uvoffset=np.asarray(uvo),
    )


@register("texture", "scale")
def _scale(props: Properties, ctx=None):
    sc = props.get_spectrum("scale", np.ones(3)) if "scale" in props else np.full(3, props.get_float("value", 1.0))
    nested = props.children.get("texture", -1)
    if ctx is None:
        return -1
    if isinstance(nested, (int, np.integer)) and nested >= 0:
        return ctx.textures.add(type=tx.TEX_SCALE, value0=sc, nested=int(nested))
    base = props.get_spectrum("value", np.ones(3)) if "value" in props else np.ones(3)
    return ctx.textures.add_constant(np.asarray(base) * sc)


@register("texture", "wireframe")
def _wireframe(props: Properties, ctx=None):
    """Wireframe needs barycentric distance-to-edge; approximated by grid."""
    c0 = props.get_spectrum("interiorColor", np.full(3, 0.5))
    c1 = props.get_spectrum("edgeColor", np.full(3, 0.1))
    lw = props.get_float("lineWidth", 0.01)
    if ctx is None:
        return -1
    return ctx.textures.add(type=tx.TEX_GRID, value0=c0, value1=c1, param0=lw)


@register("texture", "vertexcolors")
def _vertexcolors(props: Properties, ctx=None):
    """Per-vertex colors (``/root/reference/src/textures/vertexcolors.cpp:43``
    interpolates ``its.color``).  Wavefront design: the owning mesh bakes its
    corner colors into a 2x2-texel atlas block per triangle (the fourth
    texel is c1+c2-c0, which makes bilinear filtering *exactly* barycentric
    interpolation) and per-corner UVs address the block — the hot path is
    the ordinary bitmap lookup.  The bake happens when the mesh registers
    (see ``scene.shapes._finish_mesh``)."""
    if ctx is None:
        return -1
    tid = ctx.textures.add_constant(np.full(3, 0.5))
    if hasattr(ctx, "pending_vertexcolors"):
        ctx.pending_vertexcolors.append(tid)
    return tid


def bake_vertex_colors(ctx, mesh, tex_ids):
    """Bake mesh corner colors into per-triangle 2x2 atlas blocks; returns
    (T, 3, 2) per-corner UVs (or None when the mesh carries no colors)."""
    from .texture import TEX_BITMAP, WRAP_CLAMP, MAX_MIP
    from ..core.registry import warn_substitution

    idx = np.asarray(mesh.indices, np.int64)
    T = len(idx)
    if mesh.colors is None or T == 0:
        warn_substitution(
            "vertexcolors", "mesh has no per-vertex colors; using the "
            "constant 0.5 fallback")
        return None
    col = np.asarray(mesh.colors, np.float32)
    c0, c1, c2 = col[idx[:, 0]], col[idx[:, 1]], col[idx[:, 2]]
    img = np.empty((2, 2 * T, 3), np.float32)
    img[0, 0::2] = c0
    img[0, 1::2] = c1
    img[1, 0::2] = c2
    img[1, 1::2] = c1 + c2 - c0  # kills the bilinear cross term
    tb = ctx.textures
    off = tb.atlas_size
    flat = img.reshape(-1, 3)
    tb.atlas_parts.append(flat)
    tb.atlas_size += len(flat)
    for tid in tex_ids:
        tb.records[tid].update(
            type=TEX_BITMAP, offset=off, width=2 * T, height=2,
            wrap=WRAP_CLAMP, uvscale=np.ones(2), uvoffset=np.zeros(2),
            mip_offset=np.full(MAX_MIP, off, np.int64), n_levels=1,
        )
    ii = np.arange(T, dtype=np.float64)
    u0 = (2 * ii + 0.5) / (2 * T)
    u1 = (2 * ii + 1.5) / (2 * T)
    uv = np.empty((T, 3, 2), np.float64)
    uv[:, 0, 0] = u0
    uv[:, 0, 1] = 0.25
    uv[:, 1, 0] = u1
    uv[:, 1, 1] = 0.25
    uv[:, 2, 0] = u0
    uv[:, 2, 1] = 0.75
    return uv


@register("texture", "curvature")
def _curvature(props: Properties, ctx=None):
    if ctx is None:
        return -1
    return ctx.textures.add_constant(np.full(3, 0.5))
