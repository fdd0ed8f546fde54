"""Compiled scene: one pytree holding every table the kernels need.

The wavefront analog of the reference ``Scene`` object
(``/root/reference/include/mitsuba/render/scene.h:49``): geometry + BVH +
BSDF/texture/emitter tables + sensor + per-shape attribute maps, all
device-resident arrays.  Being a pytree, the entire scene flows through
``jax.jit`` arguments, can be donated, replicated or sharded with
``jax.sharding``, and is differentiable where its leaves are.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int, INVALID, EPSILON, SHADOW_EPSILON
from ..accel.bvh import FlatBVH
from ..accel import intersect as isect
from ..bsdf.common import BSDFTable, LaneParams, resolve as bsdf_resolve
from ..emitter.table import EmitterTable
from ..sensor.table import Sensor
from ..texture.texture import TextureTable
from ..media.medium import MediumTable
from .geometry import Geometry, Hit, Interaction, compute_interaction


@pytree_dataclass
class Scene:
    geom: Geometry
    bvh: FlatBVH
    bsdfs: BSDFTable
    textures: TextureTable
    emitters: EmitterTable
    media: MediumTable
    clusters: object  # Hierarchy, ClusterSet or None (big-scene intersector)
    sensor: Sensor
    shape_bsdf: jax.Array  # (S,) int32
    shape_emitter: jax.Array  # (S,) int32
    shape_interior: jax.Array  # (S,) int32 medium ids
    shape_exterior: jax.Array  # (S,) int32
    shape_subsurface: jax.Array | None = None  # (S,) int32 subsurface ids
    subsurface: object = None  # SubsurfaceTable or None
    motion: object = None  # dict of frame-1 tri arrays (deformable shapes)
    use_bvh: bool = static_field(default=False)
    camera_medium: int = static_field(default=-1)

    def with_time(self, t):
        """Shutter-time snapshot: lerp deformable keyframes on device
        (``src/shapes/deformable.cpp`` fillIntersectionRecord's alpha lerp,
        applied to the whole wavefront's shared shutter time)."""
        if self.motion is None:
            return self
        g = self.geom
        L = lambda a, b: a + (b - a) * t
        geom = g.replace(
            tri_p0=L(g.tri_p0, self.motion["p0"]),
            tri_e1=L(g.tri_e1, self.motion["e1"]),
            tri_e2=L(g.tri_e2, self.motion["e2"]),
            tri_n0=L(g.tri_n0, self.motion["n0"]),
            tri_n1=L(g.tri_n1, self.motion["n1"]),
            tri_n2=L(g.tri_n2, self.motion["n2"]),
        )
        if g.tri_shad is not None:
            from .geometry import pack_shading_rows

            m = self.motion
            shad1 = pack_shading_rows(
                m["e1"], m["e2"], m["n0"], m["n1"], m["n2"],
                g.tri_uv0, g.tri_uv1, g.tri_uv2)
            geom = geom.replace(tri_shad=L(g.tri_shad, shad1))
        out = self.replace(geom=geom)
        if (self.clusters is not None
                and getattr(self.clusters, "has_motion", False)):
            import jax.numpy as jnp

            out = out.replace(clusters=self.clusters.replace(
                time=jnp.asarray(t, geom.tri_p0.dtype)))
        return out

    # -- queries (scene.h rayIntersect / isOccluded analogs) ---------------
    def ray_intersect(self, o, d, tmin=EPSILON, tmax=1e30) -> Hit:
        return isect.intersect(
            self.geom, o, d, tmin, tmax,
            bvh=self.bvh if self.use_bvh else None, clusters=self.clusters,
        )

    def occluded(self, o, d, tmin, tmax) -> jax.Array:
        return isect.occluded(
            self.geom, o, d, tmin, tmax,
            bvh=self.bvh if self.use_bvh else None, clusters=self.clusters,
        )

    def interaction(self, o, d, hit: Hit) -> Interaction:
        it = compute_interaction(self.geom, o, d, hit)
        if self.bsdfs.has_bump:
            it = self._perturb_frame(it, d)
        return it

    def _perturb_frame(self, it: Interaction, d) -> Interaction:
        """Bump / normal mapping (bumpmap.cpp / normalmap.cpp wrappers):
        tilt the shading frame by the texture before any BSDF evaluation so
        every integrator inherits it."""
        from ..core.gather import gather_rows, RowBundle
        from ..core import math as m
        from ..bsdf.common import BUMP_HEIGHT, BUMP_NORMAL
        from ..texture.texture import eval_texture

        sid = jnp.where(it.shape == INVALID, 0, it.shape)
        bid = gather_rows(self.shape_bsdf, sid)
        bid = jnp.where(bid == INVALID, 0, bid)
        b = (
            RowBundle()
            .add("bump_tex", self.bsdfs.bump_tex)
            .add("bump_kind", self.bsdfs.bump_kind)
            .add("bump_scale", self.bsdfs.bump_scale)
        ).lookup(bid)
        active = (b["bump_kind"] > 0) & (b["bump_tex"] != INVALID) & it.valid
        if active.shape == ():  # scalar lanes: skip
            return it

        # height bump: central-difference gradient of the mean channel
        eps = 5e-4
        du = jnp.asarray([eps, 0.0], it.uv.dtype)
        dv = jnp.asarray([0.0, eps], it.uv.dtype)
        h0 = jnp.mean(eval_texture(self.textures, b["bump_tex"], it.uv, None), -1)
        hu = jnp.mean(eval_texture(self.textures, b["bump_tex"], it.uv + du, None), -1)
        hv = jnp.mean(eval_texture(self.textures, b["bump_tex"], it.uv + dv, None), -1)
        dhdu = (hu - h0) / eps * b["bump_scale"]
        dhdv = (hv - h0) / eps * b["bump_scale"]
        n_height = m.normalize(
            it.ns - dhdu[..., None] * it.ss - dhdv[..., None] * it.ts_)

        # normal map: tangent-space rgb -> [-1,1]^3
        c = eval_texture(self.textures, b["bump_tex"], it.uv, None)
        nt = m.normalize(2.0 * c - 1.0)
        n_map = m.normalize(
            nt[..., 0:1] * it.ss + nt[..., 1:2] * it.ts_ + nt[..., 2:3] * it.ns)

        ns = jnp.where((b["bump_kind"] == BUMP_HEIGHT)[..., None], n_height,
                       jnp.where((b["bump_kind"] == BUMP_NORMAL)[..., None],
                                 n_map, it.ns))
        ns = jnp.where(active[..., None], ns, it.ns)
        # keep ns in ng's hemisphere (no silhouette flips)
        ns = jnp.where((m.dot(ns, it.ng) < 0)[..., None], -ns, ns)
        ss = m.normalize(it.ss - ns * m.dot(ns, it.ss)[..., None])
        ts = m.cross(ns, ss)
        wi_local = m.Frame.to_local((ss, ts, ns), -d)
        return it.replace(ns=ns, ss=ss, ts_=ts, wi_local=wi_local)

    # -- component-SoA queries (canonical for the wavefront hot path) ------
    def ray_intersect_v(self, o, d, tmin=EPSILON, tmax=1e30,
                        active=None, coherent=False) -> Hit:
        """o, d: V3 of flat (N,) components."""
        return isect.intersect_v(
            self.geom, o, d, tmin, tmax,
            bvh=self.bvh if self.use_bvh else None, clusters=self.clusters,
            active=active, coherent=coherent,
        )

    def occluded_v(self, o, d, tmin, tmax, active=None) -> jax.Array:
        return isect.occluded_v(
            self.geom, o, d, tmin, tmax,
            bvh=self.bvh if self.use_bvh else None, clusters=self.clusters,
            active=active,
        )

    def interaction_v(self, o, d, hit: Hit):
        from .geometry import compute_interaction_v

        it = compute_interaction_v(self.geom, o, d, hit)
        if self.bsdfs.has_bump:
            it = self._perturb_frame_v(it, d)
        return it

    def _perturb_frame_v(self, it, d):
        """SoA bump / normal mapping (see _perturb_frame)."""
        from ..core import v3 as v
        from ..bsdf.common import BUMP_HEIGHT, BUMP_NORMAL
        from ..texture.texture import eval_texture_v

        sid = jnp.where(it.shape == INVALID, 0, it.shape)
        bid = v.gather_col(self.shape_bsdf, sid)
        bid = jnp.where(bid == INVALID, 0, bid)
        bump_tex = v.gather_col(self.bsdfs.bump_tex, bid)
        bump_kind = v.gather_col(self.bsdfs.bump_kind, bid)
        bump_scale = v.gather_col(self.bsdfs.bump_scale, bid)
        active = (bump_kind > 0) & (bump_tex != INVALID) & it.valid

        eps = 5e-4
        h0 = eval_texture_v(self.textures, bump_tex, it.uv_u, it.uv_v, None).mean()
        hu = eval_texture_v(self.textures, bump_tex, it.uv_u + eps, it.uv_v, None).mean()
        hv = eval_texture_v(self.textures, bump_tex, it.uv_u, it.uv_v + eps, None).mean()
        dhdu = (hu - h0) / eps * bump_scale
        dhdv = (hv - h0) / eps * bump_scale
        n_height = (it.ns - it.ss * dhdu - it.ts_ * dhdv).normalized()

        c = eval_texture_v(self.textures, bump_tex, it.uv_u, it.uv_v, None)
        nt = (c * 2.0 - 1.0).normalized()
        n_map = (it.ss * nt.x + it.ts_ * nt.y + it.ns * nt.z).normalized()

        ns = v.where(bump_kind == BUMP_HEIGHT, n_height,
                     v.where(bump_kind == BUMP_NORMAL, n_map, it.ns))
        ns = v.where(active, ns, it.ns)
        ns = v.where(ns.dot(it.ng) < 0, -ns, ns)
        ss = (it.ss - ns * ns.dot(it.ss)).normalized()
        ts = ns.cross(ss)
        wi_local = v.to_local((ss, ts, ns), -d)
        return it.replace(ns=ns, ss=ss, ts_=ts, wi_local=wi_local)

    def bsdf_at_v(self, it, u_sel=None, duv=None):
        """SoA Interaction3 -> LaneParams3.  ``duv`` (optional screen-space
        UV derivatives) enables MIP/anisotropic texture filtering."""
        from ..core import v3 as v
        from ..bsdf.common import resolve_v

        sid = jnp.where(it.shape == INVALID, 0, it.shape)
        bid = v.gather_col(self.shape_bsdf, sid)
        return resolve_v(self.bsdfs, self.textures, bid, it.uv_u, it.uv_v,
                         u_sel, duv)

    def emitter_at_id(self, shape_id) -> jax.Array:
        from ..core import v3 as v

        sid = jnp.where(shape_id == INVALID, 0, shape_id)
        return jnp.where(shape_id == INVALID, INVALID,
                         v.gather_col(self.shape_emitter, sid))

    def bsdf_at(self, it: Interaction, u_sel=None) -> LaneParams:
        from ..core.gather import gather_rows

        sid = jnp.where(it.shape == INVALID, 0, it.shape)
        bid = gather_rows(self.shape_bsdf, sid)
        return bsdf_resolve(self.bsdfs, self.textures, bid, it.uv, u_sel)

    def emitter_at(self, it: Interaction) -> jax.Array:
        from ..core.gather import gather_rows

        sid = jnp.where(it.shape == INVALID, 0, it.shape)
        return jnp.where(it.shape == INVALID, INVALID,
                         gather_rows(self.shape_emitter, sid))

    def subsurface_at(self, shape_id, valid) -> jax.Array:
        from ..core.gather import gather_rows

        if self.shape_subsurface is None:
            return jnp.full(shape_id.shape, INVALID, Int)
        sid = jnp.where(valid, shape_id, 0)
        return jnp.where(valid, gather_rows(self.shape_subsurface, sid),
                         INVALID)
