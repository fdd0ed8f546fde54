"""Flattened scene geometry: SoA primitive tables + surface interactions.

The wavefront analog of the reference's Shape/TriMesh/Intersection layer
(``/root/reference/include/mitsuba/render/shape.h:178``,
``trimesh.h:68``): all triangle meshes are concatenated into one SoA soup;
analytic spheres and disks keep exact quadric intersections.  Per-shape
attributes (BSDF id, emitter id, media) live in small indexed tables.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int, INVALID
from ..core import math as m

# Hit kinds
KIND_NONE = 0
KIND_TRI = 1
KIND_SPHERE = 2
KIND_DISK = 3


@pytree_dataclass
class Geometry:
    """Device-resident primitive soup. Arrays are padded so every kind has at
    least one (degenerate, unhittable) entry — keeps shapes static."""

    # triangles
    tri_p0: jax.Array  # (T, 3)
    tri_e1: jax.Array  # (T, 3)
    tri_e2: jax.Array  # (T, 3)
    tri_n0: jax.Array  # (T, 3) shading normals at the three vertices
    tri_n1: jax.Array
    tri_n2: jax.Array
    tri_uv0: jax.Array  # (T, 2)
    tri_uv1: jax.Array
    tri_uv2: jax.Array
    tri_shape: jax.Array  # (T,) int32

    # analytic spheres
    sph_center: jax.Array  # (S, 3)
    sph_radius: jax.Array  # (S,)
    sph_shape: jax.Array  # (S,) int32

    # analytic disks: world-space center, orthonormal frame, radius
    disk_center: jax.Array  # (D, 3)
    disk_n: jax.Array  # (D, 3)
    disk_s: jax.Array  # (D, 3)
    disk_t: jax.Array  # (D, 3)
    disk_radius: jax.Array  # (D,)
    disk_shape: jax.Array  # (D,) int32

    # per-instance normal rotations for shared-BLAS instancing
    # (``/root/reference/src/shapes/instance.cpp:115``): row 0 = identity;
    # instanced triangle attributes are stored in BLAS-local space and
    # rotated at interaction time
    inst_rot: jax.Array = None  # (I, 3, 3)

    # packed per-triangle shading row [e1 e2 n0 n1 n2 uv0 uv1 uv2 pad],
    # (T, SHAD_ROW): interaction construction is ONE row gather instead of
    # eight (N, 3)/(N, 2) gathers, which XLA laid out transposed and which
    # profiled at ~2-3 orders of magnitude over gather bandwidth on the
    # 1M-triangle bench (same lesson as accel/hierarchy.py's packed rows)
    tri_shad: jax.Array = None  # (T, SHAD_ROW)

    n_tris: int = static_field(default=0)  # real (unpadded) counts
    n_spheres: int = static_field(default=0)
    n_disks: int = static_field(default=0)
    instanced: bool = static_field(default=False)


@pytree_dataclass
class Hit:
    """Per-lane closest-hit record."""

    t: jax.Array
    kind: jax.Array  # int32, KIND_*
    prim: jax.Array  # int32 index within the kind's table
    shape: jax.Array  # int32 shape id (INVALID when miss)
    u: jax.Array  # tri: barycentric u; sphere/disk: local param
    v: jax.Array
    inst: jax.Array = None  # int32 instance id (0 = identity / non-instanced)

    @property
    def valid(self) -> jax.Array:
        return self.kind > KIND_NONE

    def inst_or_zero(self):
        return jnp.zeros_like(self.prim) if self.inst is None else self.inst


@pytree_dataclass
class Interaction:
    """Shading-point data (reference ``Intersection``, shape.h)."""

    p: jax.Array  # (..., 3) world position
    t: jax.Array
    ng: jax.Array  # geometric normal
    ns: jax.Array  # shading normal
    ss: jax.Array  # shading tangent s
    ts_: jax.Array  # shading tangent t
    uv: jax.Array  # (..., 2)
    wi_local: jax.Array  # incident dir in shading frame (toward viewer)
    shape: jax.Array  # int32
    valid: jax.Array  # bool

    def to_local(self, v):
        return m.Frame.to_local((self.ss, self.ts_, self.ns), v)

    def to_world(self, v):
        return m.Frame.to_world((self.ss, self.ts_, self.ns), v)


@pytree_dataclass
class Interaction3:
    """Component-SoA shading-point record (canonical hot-path form).

    Same information as :class:`Interaction` but every 3-vector is a
    :class:`~mitsuba_im_tpu.core.v3.V3` of flat (N,) components and ``uv``
    is split into two flat arrays.
    """

    p: object  # V3
    t: jax.Array
    ng: object  # V3
    ns: object  # V3
    ss: object  # V3
    ts_: object  # V3
    uv_u: jax.Array
    uv_v: jax.Array
    wi_local: object  # V3
    shape: jax.Array  # int32
    valid: jax.Array  # bool

    def to_local(self, w):
        from ..core import v3 as v

        return v.to_local((self.ss, self.ts_, self.ns), w)

    def to_world(self, w):
        from ..core import v3 as v

        return v.to_world((self.ss, self.ts_, self.ns), w)

    def to_aos(self) -> "Interaction":
        """Adapter for not-yet-migrated consumers."""
        return Interaction(
            p=self.p.to_array(), t=self.t, ng=self.ng.to_array(),
            ns=self.ns.to_array(), ss=self.ss.to_array(),
            ts_=self.ts_.to_array(),
            uv=jnp.stack([self.uv_u, self.uv_v], axis=-1),
            wi_local=self.wi_local.to_array(), shape=self.shape,
            valid=self.valid,
        )


SHAD_ROW = 24  # 21 used + 3 pad (see Geometry.tri_shad)


def pack_shading_rows(e1, e2, n0, n1, n2, uv0, uv1, uv2):
    """(T, SHAD_ROW) packed shading rows from component arrays (np or jnp;
    linear in every input, so keyframe lerps commute with packing)."""
    xp = jnp if isinstance(e1, jax.Array) else np
    T = e1.shape[0]
    pad = xp.zeros((T, SHAD_ROW - 21), e1.dtype)
    return xp.concatenate([e1, e2, n0, n1, n2, uv0, uv1, uv2, pad], axis=1)


def make_geometry(
    tri_data: dict | None,
    spheres: dict | None,
    disks: dict | None,
    inst_rot: np.ndarray | None = None,
) -> Geometry:
    """Build a Geometry from host numpy dicts (padding each kind to >=1).

    ``inst_rot``: (I, 3, 3) per-instance normal rotations (inverse-transpose
    of the instance linear parts) when shared-BLAS instancing is active."""

    def pad_tri():
        far = 3.0e37
        z = np.zeros((1, 3), np.float32)
        return dict(
            p0=z + far, e1=z, e2=z, n0=z, n1=z, n2=z,
            uv0=np.zeros((1, 2), np.float32), uv1=np.zeros((1, 2), np.float32),
            uv2=np.zeros((1, 2), np.float32),
            shape=np.full(1, INVALID, np.int32),
        )

    if tri_data is None or len(tri_data.get("p0", ())) == 0:
        tri_data = pad_tri()
        n_tris = 0
    else:
        n_tris = len(tri_data["p0"])

    if spheres is None or len(spheres.get("center", ())) == 0:
        spheres = dict(
            center=np.full((1, 3), 3.0e37, np.float32),
            radius=np.zeros(1, np.float32),
            shape=np.full(1, INVALID, np.int32),
        )
        n_spheres = 0
    else:
        n_spheres = len(spheres["center"])

    if disks is None or len(disks.get("center", ())) == 0:
        disks = dict(
            center=np.full((1, 3), 3.0e37, np.float32),
            n=np.tile(np.array([[0, 0, 1]], np.float32), (1, 1)),
            s=np.tile(np.array([[1, 0, 0]], np.float32), (1, 1)),
            t=np.tile(np.array([[0, 1, 0]], np.float32), (1, 1)),
            radius=np.zeros(1, np.float32),
            shape=np.full(1, INVALID, np.int32),
        )
        n_disks = 0
    else:
        n_disks = len(disks["center"])

    f = lambda x: jnp.asarray(x, Float)
    i = lambda x: jnp.asarray(x, Int)
    return Geometry(
        tri_p0=f(tri_data["p0"]), tri_e1=f(tri_data["e1"]), tri_e2=f(tri_data["e2"]),
        tri_n0=f(tri_data["n0"]), tri_n1=f(tri_data["n1"]), tri_n2=f(tri_data["n2"]),
        tri_uv0=f(tri_data["uv0"]), tri_uv1=f(tri_data["uv1"]), tri_uv2=f(tri_data["uv2"]),
        tri_shape=i(tri_data["shape"]),
        sph_center=f(spheres["center"]), sph_radius=f(spheres["radius"]),
        sph_shape=i(spheres["shape"]),
        disk_center=f(disks["center"]), disk_n=f(disks["n"]), disk_s=f(disks["s"]),
        disk_t=f(disks["t"]), disk_radius=f(disks["radius"]),
        disk_shape=i(disks["shape"]),
        inst_rot=f(np.eye(3, dtype=np.float32)[None]
                   if inst_rot is None else inst_rot),
        tri_shad=f(pack_shading_rows(
            *(np.asarray(tri_data[k], np.float32)
              for k in ("e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2")))),
        n_tris=n_tris, n_spheres=n_spheres, n_disks=n_disks,
        instanced=inst_rot is not None and len(inst_rot) > 1,
    )


def _gather3_v(tab: jax.Array, idx: jax.Array):
    """(T, 3) table row lookup as V3 (select chain for small tables)."""
    from ..core import v3 as v

    if tab.shape[0] <= v.SELECT_MAX:
        return v.gather_v3(tab, idx)
    g = tab[idx]
    return v.V3(g[..., 0], g[..., 1], g[..., 2])


def _gather2_v(tab: jax.Array, idx: jax.Array):
    from ..core import v3 as v

    if tab.shape[0] <= v.SELECT_MAX:
        return v.gather_col(tab[:, 0], idx), v.gather_col(tab[:, 1], idx)
    g = tab[idx]
    return g[..., 0], g[..., 1]


def compute_interaction_v(geom: Geometry, o, d, hit: Hit) -> Interaction3:
    """Component-SoA interaction: o, d are V3; all math at full density."""
    from ..core import v3 as v

    pr = hit.prim
    is_tri = hit.kind == KIND_TRI
    is_sph = hit.kind == KIND_SPHERE
    is_disk = hit.kind == KIND_DISK
    tp = jnp.where(is_tri, pr, 0)
    sp = jnp.where(is_sph, pr, 0)
    dp = jnp.where(is_disk, pr, 0)

    p = o + d * hit.t

    # --- triangle attributes: ONE packed row gather -----------------------
    if geom.tri_shad is not None and geom.tri_shad.shape[0] > v.SELECT_MAX:
        # the barrier pins the gather's result layout to the table's
        # row-major tiling; without it XLA propagates the per-column
        # consumers' preference and materializes the gather TRANSPOSED
        # (measured 63 ns/row vs the ~6 ns/row gather floor)
        row = jax.lax.optimization_barrier(geom.tri_shad[tp])
        V = v.V3
        e1 = V(row[:, 0], row[:, 1], row[:, 2])
        e2 = V(row[:, 3], row[:, 4], row[:, 5])
        n0 = V(row[:, 6], row[:, 7], row[:, 8])
        n1 = V(row[:, 9], row[:, 10], row[:, 11])
        n2 = V(row[:, 12], row[:, 13], row[:, 14])
        uv0u, uv0v = row[:, 15], row[:, 16]
        uv1u, uv1v = row[:, 17], row[:, 18]
        uv2u, uv2v = row[:, 19], row[:, 20]
    else:
        e1 = _gather3_v(geom.tri_e1, tp)
        e2 = _gather3_v(geom.tri_e2, tp)
        n0 = _gather3_v(geom.tri_n0, tp)
        n1 = _gather3_v(geom.tri_n1, tp)
        n2 = _gather3_v(geom.tri_n2, tp)
        uv0u, uv0v = _gather2_v(geom.tri_uv0, tp)
        uv1u, uv1v = _gather2_v(geom.tri_uv1, tp)
        uv2u, uv2v = _gather2_v(geom.tri_uv2, tp)
    ng_tri = e1.cross(e2).normalized()
    w = 1.0 - hit.u - hit.v
    ns_tri = (n0 * w + n1 * hit.u + n2 * hit.v).normalized()
    if geom.instanced:
        # rotate BLAS-local normals into world space per instance: nine
        # rotation components fetched as flat columns (I is tiny)
        Rf = geom.inst_rot.reshape(geom.inst_rot.shape[0], 9)
        ii = jnp.clip(hit.inst_or_zero(), 0, Rf.shape[0] - 1)
        rc = [v.gather_col(Rf[:, k], ii) if Rf.shape[0] <= v.SELECT_MAX
              else Rf[ii, k] for k in range(9)]

        def rot_v3(n):
            return v.V3(
                rc[0] * n.x + rc[1] * n.y + rc[2] * n.z,
                rc[3] * n.x + rc[4] * n.y + rc[5] * n.z,
                rc[6] * n.x + rc[7] * n.y + rc[8] * n.z,
            ).normalized()

        ng_tri = rot_v3(ng_tri)
        ns_tri = rot_v3(ns_tri)
    uvu_tri = uv0u * w + uv1u * hit.u + uv2u * hit.v
    uvv_tri = uv0v * w + uv1v * hit.u + uv2v * hit.v

    # --- sphere attributes ---
    sc = _gather3_v(geom.sph_center, sp)
    ns_sph = (p - sc).normalized()
    theta, phi = v.spherical_coordinates(ns_sph)
    uvu_sph = phi / (2 * jnp.pi)
    uvv_sph = theta / jnp.pi

    # --- disk attributes ---
    dc = _gather3_v(geom.disk_center, dp)
    dn = _gather3_v(geom.disk_n, dp)
    ds = _gather3_v(geom.disk_s, dp)
    dt = _gather3_v(geom.disk_t, dp)
    if geom.disk_radius.shape[0] <= v.SELECT_MAX:
        dr = v.gather_col(geom.disk_radius, dp)
    else:
        dr = geom.disk_radius[dp]
    local = p - dc
    lx = local.dot(ds)
    ly = local.dot(dt)
    r_ = jnp.sqrt(lx * lx + ly * ly) / jnp.maximum(dr, 1e-20)
    phi_d = jnp.arctan2(ly, lx)
    phi_d = jnp.where(phi_d < 0, phi_d + 2 * jnp.pi, phi_d)

    ng = v.where(is_tri, ng_tri, v.where(is_sph, ns_sph, dn))
    ns = v.where(is_tri, ns_tri, v.where(is_sph, ns_sph, dn))
    uv_u = jnp.where(is_tri, uvu_tri, jnp.where(is_sph, uvu_sph, r_))
    uv_v = jnp.where(is_tri, uvv_tri,
                     jnp.where(is_sph, uvv_sph, phi_d / (2 * jnp.pi)))

    ss, ts_ = v.coordinate_system(ns)
    wi_local = v.to_local((ss, ts_, ns), -d)
    return Interaction3(
        p=p, t=hit.t, ng=ng, ns=ns, ss=ss, ts_=ts_, uv_u=uv_u, uv_v=uv_v,
        wi_local=wi_local,
        shape=jnp.where(hit.valid, hit.shape, INVALID),
        valid=hit.valid,
    )


def compute_interaction(geom: Geometry, o: jax.Array, d: jax.Array, hit: Hit) -> Interaction:
    """Expand a Hit into a full shading-point record.

    All per-kind attributes of a primitive are packed into one matrix so
    each lane does a single bundled row lookup (select-chain/wide gather)
    instead of a dozen scalar gathers.
    """
    from ..core.gather import RowBundle

    pr = hit.prim
    is_tri = hit.kind == KIND_TRI
    is_sph = hit.kind == KIND_SPHERE
    is_disk = hit.kind == KIND_DISK
    tp = jnp.where(is_tri, pr, 0)
    sp = jnp.where(is_sph, pr, 0)
    dp = jnp.where(is_disk, pr, 0)

    p = o + d * hit.t[..., None]

    # --- triangle attributes (one bundled lookup) ---
    tb = (
        RowBundle()
        .add("e1", geom.tri_e1).add("e2", geom.tri_e2)
        .add("n0", geom.tri_n0).add("n1", geom.tri_n1).add("n2", geom.tri_n2)
        .add("uv0", geom.tri_uv0).add("uv1", geom.tri_uv1).add("uv2", geom.tri_uv2)
    ).lookup(tp)
    ng_tri = m.normalize(m.cross(tb["e1"], tb["e2"]))
    w = 1.0 - hit.u - hit.v
    ns_tri = m.normalize(
        tb["n0"] * w[..., None]
        + tb["n1"] * hit.u[..., None]
        + tb["n2"] * hit.v[..., None]
    )
    if geom.instanced:
        # rotate BLAS-local normals into world space per instance
        R = geom.inst_rot[jnp.clip(hit.inst_or_zero(), 0,
                                   geom.inst_rot.shape[0] - 1)]
        rot = lambda n: m.normalize(jnp.einsum("...ij,...j->...i", R, n,
                                                  precision=jax.lax.Precision.HIGHEST))
        ng_tri = rot(ng_tri)
        ns_tri = rot(ns_tri)
    uv_tri = (
        tb["uv0"] * w[..., None]
        + tb["uv1"] * hit.u[..., None]
        + tb["uv2"] * hit.v[..., None]
    )

    # --- sphere attributes ---
    sb = RowBundle().add("c", geom.sph_center).lookup(sp)
    ns_sph = m.normalize(p - sb["c"])
    theta, phi = m.spherical_coordinates(ns_sph)
    uv_sph = jnp.stack([phi / (2 * jnp.pi), theta / jnp.pi], axis=-1)

    # --- disk attributes ---
    db = (
        RowBundle()
        .add("c", geom.disk_center).add("n", geom.disk_n)
        .add("s", geom.disk_s).add("t", geom.disk_t)
        .add("r", geom.disk_radius)
    ).lookup(dp)
    ns_disk = db["n"]
    local = p - db["c"]
    lx = m.dot(local, db["s"])
    ly = m.dot(local, db["t"])
    r_ = jnp.sqrt(lx * lx + ly * ly) / jnp.maximum(db["r"], 1e-20)
    phi_d = jnp.arctan2(ly, lx)
    phi_d = jnp.where(phi_d < 0, phi_d + 2 * jnp.pi, phi_d)
    uv_disk = jnp.stack([r_, phi_d / (2 * jnp.pi)], axis=-1)

    ng = jnp.where(
        is_tri[..., None], ng_tri, jnp.where(is_sph[..., None], ns_sph, ns_disk)
    )
    ns = jnp.where(
        is_tri[..., None], ns_tri, jnp.where(is_sph[..., None], ns_sph, ns_disk)
    )
    uv = jnp.where(
        is_tri[..., None], uv_tri, jnp.where(is_sph[..., None], uv_sph, uv_disk)
    )

    ss, ts_ = m.coordinate_system(ns)
    frame = (ss, ts_, ns)
    wi_local = m.Frame.to_local(frame, -d)
    return Interaction(
        p=p, t=hit.t, ng=ng, ns=ns, ss=ss, ts_=ts_, uv=uv,
        wi_local=wi_local,
        shape=jnp.where(hit.valid, hit.shape, INVALID),
        valid=hit.valid,
    )
