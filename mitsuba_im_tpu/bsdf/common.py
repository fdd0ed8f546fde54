"""BSDF parameter tables and per-lane resolution.

The reference's BSDF plugin hierarchy (``/root/reference/src/bsdfs/``,
``include/mitsuba/render/bsdf.h``) becomes a *table of typed parameter
records*: each scene BSDF instance is one row; wavefront lanes gather their
row (+ texture lookups) into a ``LaneParams`` pytree, and evaluation
dispatches on the integer type code over only the types present in the
scene (``used_types`` is static, so XLA compiles just those branches).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int, INVALID
from ..texture.texture import TextureTable, eval_texture
from .microfacet import DIST_BECKMANN, DIST_GGX, DIST_PHONG

# Type codes (one per reference bsdf plugin; SURVEY.md §2.5)
DIFFUSE = 0
ROUGHDIFFUSE = 1
CONDUCTOR = 2
ROUGHCONDUCTOR = 3
DIELECTRIC = 4
THINDIELECTRIC = 5
ROUGHDIELECTRIC = 6
PLASTIC = 7
ROUGHPLASTIC = 8
PHONG = 9
WARD = 10
NULL_BSDF = 11
DIFFTRANS = 12
COATING = 13
MASK = 14
BLEND = 15
BUMPMAP_WRAP = 16  # handled at resolve level
HK = 17
IRAWAN = 18

TYPE_NAMES = {
    DIFFUSE: "diffuse", ROUGHDIFFUSE: "roughdiffuse", CONDUCTOR: "conductor",
    ROUGHCONDUCTOR: "roughconductor", DIELECTRIC: "dielectric",
    THINDIELECTRIC: "thindielectric", ROUGHDIELECTRIC: "roughdielectric",
    PLASTIC: "plastic", ROUGHPLASTIC: "roughplastic", PHONG: "phong",
    WARD: "ward", NULL_BSDF: "null", DIFFTRANS: "difftrans",
    MASK: "mask", BLEND: "blendbsdf", HK: "hk", IRAWAN: "irawan",
    COATING: "coating",
}

# Frame-perturbation kinds (bumpmap.cpp / normalmap.cpp wrappers)
BUMP_NONE = 0
BUMP_HEIGHT = 1
BUMP_NORMAL = 2

# Delta-only types (no smooth component -> skip NEE at these vertices)
DELTA_TYPES = (CONDUCTOR, DIELECTRIC, THINDIELECTRIC, NULL_BSDF)

FLAG_TWOSIDED = 1


@pytree_dataclass
class BSDFTable:
    type: jax.Array  # (B,) int32
    dist: jax.Array  # (B,) int32 microfacet distribution
    refl: jax.Array  # (B, 3) diffuse reflectance
    refl_tex: jax.Array  # (B,) int32 texture id or INVALID
    spec: jax.Array  # (B, 3) specular reflectance
    spec_tex: jax.Array
    trans: jax.Array  # (B, 3) transmittance
    trans_tex: jax.Array
    eta: jax.Array  # (B, 3) conductor ior (rgb)
    k: jax.Array  # (B, 3) conductor absorption
    eta_s: jax.Array  # (B,) dielectric relative ior (int/ext)
    alpha_u: jax.Array  # (B,) roughness (or phong exponent encoding)
    alpha_v: jax.Array
    alpha_tex: jax.Array  # (B,) int32
    exponent: jax.Array  # (B,) phong/ward exponent
    opacity: jax.Array  # (B, 3) mask opacity
    opacity_tex: jax.Array
    flags: jax.Array  # (B,) int32 (twosided etc.)
    nested: jax.Array  # (B,) int32 nested bsdf id (mask/blend)
    nested2: jax.Array  # (B,) int32 second nested (blend)
    weight: jax.Array  # (B,) blend weight toward nested2
    weight_tex: jax.Array  # (B,) int32 blend weight texture
    bump_tex: jax.Array  # (B,) int32 height/normal texture
    bump_kind: jax.Array  # (B,) int32 BUMP_*
    bump_scale: jax.Array  # (B,)
    weave_id: jax.Array = None  # (B,) int32 index into `weaves` (irawan)
    used_types: tuple = static_field(default=(DIFFUSE,))
    unwrap_depth: int = static_field(default=0)
    has_bump: bool = static_field(default=False)
    weaves: tuple = static_field(default=())  # irawan WeavePattern objects

    @property
    def n(self):
        return self.type.shape[0]


def default_record() -> dict:
    return dict(
        type=DIFFUSE, dist=DIST_BECKMANN,
        refl=np.full(3, 0.5), refl_tex=INVALID,
        spec=np.ones(3), spec_tex=INVALID,
        trans=np.ones(3), trans_tex=INVALID,
        eta=np.zeros(3), k=np.ones(3), eta_s=1.5046,
        alpha_u=0.1, alpha_v=0.1, alpha_tex=INVALID,
        exponent=30.0,
        opacity=np.full(3, 0.5), opacity_tex=INVALID,
        flags=0, nested=INVALID, nested2=INVALID,
        weight=0.5, weight_tex=INVALID,
        bump_tex=INVALID, bump_kind=BUMP_NONE, bump_scale=1.0,
    )


def build_table(records: list[dict]) -> BSDFTable:
    recs = records or [default_record()]
    g = lambda k, dt: jnp.asarray(np.stack([np.asarray(r[k]) for r in recs]), dt)
    types = {int(r["type"]) for r in recs}
    # irawan weave patterns: dedupe into a static tuple, per-row index
    weaves: list = []
    weave_ids = []
    for r in recs:
        wv = r.get("weave")
        if wv is None:
            weave_ids.append(0)
        else:
            if wv not in weaves:
                weaves.append(wv)
            weave_ids.append(weaves.index(wv))
    # static unwrap budget: BLEND chains (mixturebsdf trees) may stack a few
    # levels deep, possibly over MASK wrappers; plain scenes skip the pass
    if BLEND in types:
        depth = 4
    elif MASK in types:
        depth = 1
    else:
        depth = 0
    return BSDFTable(
        type=g("type", Int), dist=g("dist", Int),
        refl=g("refl", Float), refl_tex=g("refl_tex", Int),
        spec=g("spec", Float), spec_tex=g("spec_tex", Int),
        trans=g("trans", Float), trans_tex=g("trans_tex", Int),
        eta=g("eta", Float), k=g("k", Float), eta_s=g("eta_s", Float),
        alpha_u=g("alpha_u", Float), alpha_v=g("alpha_v", Float),
        alpha_tex=g("alpha_tex", Int), exponent=g("exponent", Float),
        opacity=g("opacity", Float), opacity_tex=g("opacity_tex", Int),
        flags=g("flags", Int), nested=g("nested", Int), nested2=g("nested2", Int),
        weight=g("weight", Float), weight_tex=g("weight_tex", Int),
        bump_tex=g("bump_tex", Int), bump_kind=g("bump_kind", Int),
        bump_scale=g("bump_scale", Float),
        weave_id=jnp.asarray(weave_ids, Int),
        used_types=tuple(sorted(types)),
        unwrap_depth=depth,
        has_bump=any(int(r.get("bump_kind", BUMP_NONE)) != BUMP_NONE for r in recs),
        weaves=tuple(weaves),
    )


@pytree_dataclass
class LaneParams:
    """Per-lane resolved BSDF parameters (textures already applied)."""

    type: jax.Array  # (...,) int32
    dist: jax.Array
    refl: jax.Array  # (..., 3)
    spec: jax.Array
    trans: jax.Array
    eta: jax.Array  # (..., 3)
    k: jax.Array
    eta_s: jax.Array  # (...,)
    alpha_u: jax.Array
    alpha_v: jax.Array
    exponent: jax.Array
    opacity: jax.Array  # (...,) scalar opacity (mask)
    flags: jax.Array
    uv_u: jax.Array = None  # surface uv (spatially-varying models: irawan)
    uv_v: jax.Array = None
    weave_id: jax.Array = None
    used_types: tuple = static_field(default=(DIFFUSE,))
    weaves: tuple = static_field(default=())


@pytree_dataclass
class LaneParams3:
    """Component-SoA per-lane BSDF parameters (canonical hot-path form):
    spectra are V3 of flat (N,) arrays, scalars are flat (N,)."""

    type: jax.Array
    dist: jax.Array
    refl: object  # V3
    spec: object  # V3
    trans: object  # V3
    eta: object  # V3
    k: object  # V3
    eta_s: jax.Array
    alpha_u: jax.Array
    alpha_v: jax.Array
    exponent: jax.Array
    opacity: jax.Array
    flags: jax.Array
    uv_u: jax.Array = None
    uv_v: jax.Array = None
    weave_id: jax.Array = None
    used_types: tuple = static_field(default=(DIFFUSE,))
    weaves: tuple = static_field(default=())

    def to_aos(self) -> "LaneParams":
        return LaneParams(
            type=self.type, dist=self.dist, refl=self.refl.to_array(),
            spec=self.spec.to_array(), trans=self.trans.to_array(),
            eta=self.eta.to_array(), k=self.k.to_array(), eta_s=self.eta_s,
            alpha_u=self.alpha_u, alpha_v=self.alpha_v,
            exponent=self.exponent, opacity=self.opacity, flags=self.flags,
            uv_u=self.uv_u, uv_v=self.uv_v, weave_id=self.weave_id,
            used_types=self.used_types, weaves=self.weaves,
        )


def lane_params_to_v(p: LaneParams) -> LaneParams3:
    from ..core.v3 import V3

    return LaneParams3(
        type=p.type, dist=p.dist, refl=V3.from_array(p.refl),
        spec=V3.from_array(p.spec), trans=V3.from_array(p.trans),
        eta=V3.from_array(p.eta), k=V3.from_array(p.k), eta_s=p.eta_s,
        alpha_u=p.alpha_u, alpha_v=p.alpha_v, exponent=p.exponent,
        opacity=p.opacity, flags=p.flags,
        uv_u=p.uv_u, uv_v=p.uv_v, weave_id=p.weave_id,
        used_types=p.used_types, weaves=p.weaves,
    )


def resolve_v(table: BSDFTable, tex: TextureTable, bsdf_id: jax.Array,
              uv_u: jax.Array, uv_v: jax.Array,
              u_sel: jax.Array | None = None, duv=None) -> LaneParams3:
    """Component-SoA parameter resolve: per-column fused select chains
    (full tile density) instead of one wide (N, C) matrix lookup.  Same
    MASK/BLEND unwrap semantics as :func:`resolve`.
    """
    from ..core import v3 as v
    from ..texture.texture import eval_texture_v

    B = table.type.shape[0]
    if B <= v.SELECT_MAX:
        gc = lambda col, idx: v.gather_col(col, idx)
        g3 = lambda tab, idx: v.gather_v3(tab, idx)
    else:
        gc = lambda col, idx: col[idx]
        g3 = lambda tab, idx: v.V3.from_array(tab[idx])

    bid = jnp.where(bsdf_id == INVALID, 0, bsdf_id)
    op_scalar = jnp.ones(bid.shape, Float)
    if table.unwrap_depth > 0:
        if u_sel is None:
            u = _hash_uniform(jnp.stack([uv_u, uv_v], axis=-1))
        else:
            u = u_sel
        for _ in range(table.unwrap_depth):
            # read every wrapper column at the iteration-entry bid
            wtype = gc(table.type, bid)
            nested = gc(table.nested, bid)
            nested2 = gc(table.nested2, bid)
            weight = gc(table.weight, bid)
            weight_tex = gc(table.weight_tex, bid)
            is_mask = wtype == MASK
            opacity = eval_texture_v(tex, gc(table.opacity_tex, bid),
                                     uv_u, uv_v, g3(table.opacity, bid))
            op = jnp.clip(opacity.mean(), 0.0, 1.0)
            op_scalar = op_scalar * jnp.where(is_mask, op, 1.0)
            bid = jnp.where(is_mask & (nested != INVALID), nested, bid)
            if BLEND in table.used_types:
                is_blend = wtype == BLEND
                wgt_rgb = eval_texture_v(tex, weight_tex, uv_u, uv_v,
                                         v.V3(weight, weight, weight))
                wgt = jnp.clip(wgt_rgb.mean(), 0.0, 1.0)
                pick2 = u < wgt
                bid = jnp.where(
                    is_blend, jnp.where(pick2, nested2, nested), bid)
                u_re = jnp.where(pick2,
                                 u / jnp.maximum(wgt, 1e-8),
                                 (u - wgt) / jnp.maximum(1.0 - wgt, 1e-8))
                u = jnp.where(is_blend, jnp.clip(u_re, 0.0, 0.999999), u)
            bid = jnp.where(bid == INVALID, 0, bid)

    alpha_tex = gc(table.alpha_tex, bid)
    alpha_rgb = eval_texture_v(tex, alpha_tex, uv_u, uv_v, None)
    alpha_from_tex = alpha_rgb.mean()
    has_atex = alpha_tex != INVALID
    au = jnp.where(has_atex, alpha_from_tex, gc(table.alpha_u, bid))
    av = jnp.where(has_atex, alpha_from_tex, gc(table.alpha_v, bid))

    return LaneParams3(
        type=gc(table.type, bid),
        dist=gc(table.dist, bid),
        refl=eval_texture_v(tex, gc(table.refl_tex, bid), uv_u, uv_v,
                            g3(table.refl, bid), duv),
        spec=eval_texture_v(tex, gc(table.spec_tex, bid), uv_u, uv_v,
                            g3(table.spec, bid), duv),
        trans=eval_texture_v(tex, gc(table.trans_tex, bid), uv_u, uv_v,
                             g3(table.trans, bid), duv),
        eta=g3(table.eta, bid),
        k=g3(table.k, bid),
        eta_s=gc(table.eta_s, bid),
        alpha_u=jnp.maximum(au, 1e-4),
        alpha_v=jnp.maximum(av, 1e-4),
        exponent=gc(table.exponent, bid),
        opacity=op_scalar,
        flags=gc(table.flags, bid),
        uv_u=uv_u, uv_v=uv_v,
        weave_id=(gc(table.weave_id, bid) if table.weaves else None),
        used_types=table.used_types,
        weaves=table.weaves,
    )


def _hash_uniform(uv: jax.Array) -> jax.Array:
    """Fallback per-lane uniform derived from the uv bit pattern — used when
    the caller has no sampler at hand (decorrelates across shading points)."""
    from ..core import rng as mrng

    bits = jax.lax.bitcast_convert_type(uv.astype(jnp.float32), jnp.uint32)
    h = mrng.hash_u32(bits[..., 0], bits[..., 1])
    return (h >> 8).astype(jnp.float32) * (1.0 / (1 << 24))


def resolve(table: BSDFTable, tex: TextureTable, bsdf_id: jax.Array,
            uv: jax.Array, u_sel: jax.Array | None = None) -> LaneParams:
    """Gather per-lane parameters; iteratively resolves MASK and BLEND
    wrappers (a MASK lane carries its nested bsdf's params + the opacity
    value; a BLEND/mixture lane stochastically selects one component per
    shading vertex with probability = blend weight, which is an unbiased
    estimator of the mixture by linearity of transport — blendbsdf.cpp
    evaluates the convex combination deterministically instead).

    All table columns ride in ONE bundled row lookup (select chain on small
    tables) rather than one gather per column.
    """
    from ..core.gather import RowBundle

    bid = jnp.where(bsdf_id == INVALID, 0, bsdf_id)
    op_scalar = jnp.ones(bid.shape, Float)
    if table.unwrap_depth > 0:
        u = u_sel if u_sel is not None else _hash_uniform(uv)
        for _ in range(table.unwrap_depth):
            w = (
                RowBundle()
                .add("type", table.type).add("nested", table.nested)
                .add("nested2", table.nested2).add("weight", table.weight)
                .add("weight_tex", table.weight_tex)
                .add("opacity", table.opacity).add("opacity_tex", table.opacity_tex)
            ).lookup(bid)
            is_mask = w["type"] == MASK
            is_blend = w["type"] == BLEND
            opacity = eval_texture(tex, w["opacity_tex"], uv, w["opacity"])
            op = jnp.clip(jnp.mean(opacity, axis=-1), 0.0, 1.0)
            op_scalar = op_scalar * jnp.where(is_mask, op, 1.0)
            bid = jnp.where(is_mask & (w["nested"] != INVALID), w["nested"], bid)
            if BLEND in table.used_types:
                wgt_rgb = eval_texture(tex, w["weight_tex"], uv,
                                       w["weight"][..., None] * jnp.ones(3))
                wgt = jnp.clip(jnp.mean(wgt_rgb, axis=-1), 0.0, 1.0)
                pick2 = u < wgt
                bid = jnp.where(is_blend,
                                jnp.where(pick2, w["nested2"], w["nested"]), bid)
                # sample reuse: rescale u so deeper blend levels see a fresh
                # uniform (Sampler sampleReuse pattern)
                u_re = jnp.where(pick2,
                                 u / jnp.maximum(wgt, 1e-8),
                                 (u - wgt) / jnp.maximum(1.0 - wgt, 1e-8))
                u = jnp.where(is_blend, jnp.clip(u_re, 0.0, 0.999999), u)
            bid = jnp.where(bid == INVALID, 0, bid)

    # pass 2: full parameter bundle at the (possibly unwrapped) id
    r = (
        RowBundle()
        .add("type", table.type).add("dist", table.dist)
        .add("refl", table.refl).add("refl_tex", table.refl_tex)
        .add("spec", table.spec).add("spec_tex", table.spec_tex)
        .add("trans", table.trans).add("trans_tex", table.trans_tex)
        .add("eta", table.eta).add("k", table.k).add("eta_s", table.eta_s)
        .add("alpha_u", table.alpha_u).add("alpha_v", table.alpha_v)
        .add("alpha_tex", table.alpha_tex).add("exponent", table.exponent)
        .add("flags", table.flags)
    ).lookup(bid)

    alpha_rgb = eval_texture(tex, r["alpha_tex"], uv, None)
    alpha_from_tex = jnp.mean(alpha_rgb, axis=-1)
    has_atex = r["alpha_tex"] != INVALID
    au = jnp.where(has_atex, alpha_from_tex, r["alpha_u"])
    av = jnp.where(has_atex, alpha_from_tex, r["alpha_v"])

    return LaneParams(
        type=r["type"],
        dist=r["dist"],
        refl=eval_texture(tex, r["refl_tex"], uv, r["refl"]),
        spec=eval_texture(tex, r["spec_tex"], uv, r["spec"]),
        trans=eval_texture(tex, r["trans_tex"], uv, r["trans"]),
        eta=r["eta"],
        k=r["k"],
        eta_s=r["eta_s"],
        alpha_u=jnp.maximum(au, 1e-4),
        alpha_v=jnp.maximum(av, 1e-4),
        exponent=r["exponent"],
        opacity=op_scalar,
        flags=r["flags"],
        uv_u=uv[..., 0], uv_v=uv[..., 1],
        weave_id=(table.weave_id[bid] if table.weaves else None),
        used_types=table.used_types,
        weaves=table.weaves,
    )


def lane_is_delta(p: LaneParams) -> jax.Array:
    """Lanes whose BSDF has no smooth component (skip NEE there)."""
    out = jnp.zeros(p.type.shape, bool)
    for t in DELTA_TYPES:
        out = out | (p.type == t)
    return out
