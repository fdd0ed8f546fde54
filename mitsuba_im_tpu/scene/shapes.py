"""Shape plugin factories (``/root/reference/src/shapes/``).

Each factory tessellates/registers its geometry into the SceneBuilder and
wires per-shape BSDF/emitter links.  Analytic sphere/disk keep exact
intersections; rectangle/cube are exact triangle sets; cylinder is
tessellated (analytic quadric planned).
"""
from __future__ import annotations

import numpy as np

from ..core.registry import register
from ..core.properties import Properties
from ..core.transform import Transform
from ..core.types import INVALID
from ..emitter import table as et
from . import mesh as mesh_mod
from .mesh import TriMesh


def _shape_common(props: Properties, ctx):
    """Resolve bsdf/emitter/medium/subsurface children."""
    b = props.children.get("bsdf")
    if isinstance(b, dict):
        bsdf_id = ctx.add_bsdf(b)
    elif isinstance(b, (int, np.integer)):
        bsdf_id = int(b)
    else:
        bsdf_id = ctx.default_bsdf()
    em_rec = props.children.get("emitter")

    def medium_id(key):
        rec = props.children.get(key)
        if isinstance(rec, dict) and "id" in rec:
            return rec["id"]
        return INVALID

    ss = props.children.get("subsurface")
    if isinstance(ss, dict):
        ss_id = ctx.add_subsurface(ss)
    elif isinstance(ss, (int, np.integer)):
        ss_id = int(ss)
    else:
        ss_id = INVALID

    return bsdf_id, em_rec, medium_id("interior"), medium_id("exterior"), ss_id


def _attach_area_emitter(ctx, em_rec, shape_id, kind, prim=0, surface_area=1.0):
    em_rec = dict(em_rec)
    em_rec["shape"] = shape_id
    em_rec["area_kind"] = kind
    em_rec["prim"] = prim
    em_rec["surface_area"] = surface_area
    eid = ctx.add_emitter(em_rec)
    ctx.shape_emitter[shape_id] = eid


def _finish_mesh(props, ctx, mesh: TriMesh):
    to_world = props.get_transform("toWorld", Transform())
    flip = props.get_bool("flipNormals", False)
    face_normals = props.get_bool("faceNormals", False)
    mesh = mesh.transformed(to_world)
    if to_world.det3() < 0:
        flip = not flip
    if flip:
        mesh.indices = mesh.indices[:, [0, 2, 1]]
        if mesh.normals is not None:
            mesh.normals = -mesh.normals
    bsdf_id, em_rec, mi, me, ss_id = _shape_common(props, ctx)
    sid = ctx.new_shape(bsdf_id, interior=mi, exterior=me, subsurface=ss_id)
    corner_uvs = None
    if getattr(ctx, "pending_vertexcolors", None):
        from ..texture import bake_vertex_colors

        pend, ctx.pending_vertexcolors = ctx.pending_vertexcolors, []
        corner_uvs = bake_vertex_colors(ctx, mesh, pend)
    ctx.add_trimesh(mesh, sid, face_normals=face_normals,
                    corner_uvs=corner_uvs)
    if em_rec is not None:
        area = float(mesh.surface_areas().sum())
        _attach_area_emitter(ctx, em_rec, sid, et.AK_TRIMESH, surface_area=area)
    return sid


@register("shape", "obj")
def _obj(props: Properties, ctx=None):
    path = ctx.resolve_path(props.get_string("filename"))
    mesh = mesh_mod.load_obj(path, flip_tex_coords=props.get_bool("flipTexCoords", True))
    if mesh.normals is None and not props.get_bool("faceNormals", False):
        mesh.compute_normals()
    return _finish_mesh(props, ctx, mesh)


@register("shape", "ply")
def _ply(props: Properties, ctx=None):
    path = ctx.resolve_path(props.get_string("filename"))
    mesh = mesh_mod.load_ply(path)
    if mesh.normals is None and not props.get_bool("faceNormals", False):
        mesh.compute_normals()
    props.get_bool("srgb", True)
    return _finish_mesh(props, ctx, mesh)


@register("shape", "serialized")
def _serialized(props: Properties, ctx=None):
    path = ctx.resolve_path(props.get_string("filename"))
    mesh = mesh_mod.load_serialized(path, shape_index=props.get_int("shapeIndex", 0))
    if mesh.normals is None and not props.get_bool("faceNormals", False):
        mesh.compute_normals()
    return _finish_mesh(props, ctx, mesh)


@register("shape", "sphere")
def _sphere(props: Properties, ctx=None):
    to_world = props.get_transform("toWorld", Transform())
    center = props.get_point("center", np.zeros(3))
    radius = props.get_float("radius", 1.0)
    center = to_world.apply_point(center)
    # uniform scale support: take the average axis scale
    scale = np.linalg.norm(to_world.m[:3, :3], axis=0).mean()
    radius = float(radius * scale)
    bsdf_id, em_rec, mi, me, ss_id = _shape_common(props, ctx)
    sid = ctx.new_shape(bsdf_id, interior=mi, exterior=me, subsurface=ss_id)
    prim = ctx.add_sphere(center, radius, sid)
    if em_rec is not None:
        _attach_area_emitter(
            ctx, em_rec, sid, et.AK_SPHERE, prim=prim,
            surface_area=4.0 * np.pi * radius * radius,
        )
    return sid


@register("shape", "disk")
def _disk(props: Properties, ctx=None):
    to_world = props.get_transform("toWorld", Transform())
    c = to_world.apply_point([0, 0, 0])
    s_axis = to_world.apply_vector([1, 0, 0])
    t_axis = to_world.apply_vector([0, 1, 0])
    radius = float(np.linalg.norm(s_axis))
    n = np.cross(s_axis, t_axis)
    n /= max(np.linalg.norm(n), 1e-12)
    if props.get_bool("flipNormals", False):
        n = -n
    s_u = s_axis / max(np.linalg.norm(s_axis), 1e-12)
    t_u = np.cross(n, s_u)
    bsdf_id, em_rec, mi, me, ss_id = _shape_common(props, ctx)
    sid = ctx.new_shape(bsdf_id, interior=mi, exterior=me, subsurface=ss_id)
    prim = ctx.add_disk(c, n, s_u, t_u, radius, sid)
    if em_rec is not None:
        _attach_area_emitter(
            ctx, em_rec, sid, et.AK_DISK, prim=prim,
            surface_area=np.pi * radius * radius,
        )
    return sid


def _quad_mesh():
    p = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64)
    idx = np.array([[0, 1, 2], [2, 3, 0]], np.int64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    n = np.tile([[0.0, 0.0, 1.0]], (4, 1))
    return TriMesh(p, idx, n, uv)


@register("shape", "rectangle")
def _rectangle(props: Properties, ctx=None):
    return _finish_mesh(props, ctx, _quad_mesh())


@register("shape", "cube")
def _cube(props: Properties, ctx=None):
    faces = []
    base = _quad_mesh()
    xf = [
        Transform.translate([0, 0, 1]),
        Transform.rotate([0, 1, 0], 180) @ Transform.translate([0, 0, 1]),
        Transform.rotate([0, 1, 0], 90) @ Transform.translate([0, 0, 1]),
        Transform.rotate([0, 1, 0], -90) @ Transform.translate([0, 0, 1]),
        Transform.rotate([1, 0, 0], -90) @ Transform.translate([0, 0, 1]),
        Transform.rotate([1, 0, 0], 90) @ Transform.translate([0, 0, 1]),
    ]
    pos, idx, nrm, uv = [], [], [], []
    off = 0
    for t in xf:
        m = base.transformed(t)
        pos.append(m.positions)
        nrm.append(m.normals)
        uv.append(m.uvs)
        idx.append(m.indices + off)
        off += 4
    mesh = TriMesh(
        np.concatenate(pos), np.concatenate(idx),
        np.concatenate(nrm), np.concatenate(uv),
    )
    return _finish_mesh(props, ctx, mesh)


@register("shape", "cylinder")
def _cylinder(props: Properties, ctx=None):
    """Tessellated cylinder (analytic quadric variant planned)."""
    p0 = props.get_point("p0", np.array([0, 0, 0.0]))
    p1 = props.get_point("p1", np.array([0, 0, 1.0]))
    radius = props.get_float("radius", 1.0)
    n_seg = 64
    axis = np.asarray(p1) - np.asarray(p0)
    h = np.linalg.norm(axis)
    az = axis / max(h, 1e-12)
    ax = np.cross(az, [0, 0, 1.0])
    if np.linalg.norm(ax) < 1e-6:
        ax = np.cross(az, [0, 1.0, 0])
    ax /= np.linalg.norm(ax)
    ay = np.cross(az, ax)
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.outer(np.cos(ang), ax) + np.outer(np.sin(ang), ay)
    bot = p0 + radius * ring
    top = bot + axis
    pos = np.concatenate([bot, top])
    nrm = np.concatenate([ring, ring])
    idx = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        idx += [[i, j, n_seg + i], [j, n_seg + j, n_seg + i]]
    uv = np.concatenate([
        np.stack([ang / (2 * np.pi), np.zeros(n_seg)], 1),
        np.stack([ang / (2 * np.pi), np.ones(n_seg)], 1),
    ])
    mesh = TriMesh(pos, np.asarray(idx, np.int64), nrm, uv)
    return _finish_mesh(props, ctx, mesh)


@register("shape", "heightfield")
def _heightfield(props: Properties, ctx=None):
    from ..io import bitmap as bmp

    path = ctx.resolve_path(props.get_string("filename"))
    img = bmp.load(path, gamma_correct=False)
    hmap = img[..., :3].mean(-1) * props.get_float("scale", 1.0)
    H, W = hmap.shape
    ys, xs = np.meshgrid(
        np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij"
    )
    pos = np.stack([xs, ys, hmap], axis=-1).reshape(-1, 3)
    uv = np.stack([(xs + 1) / 2, (ys + 1) / 2], axis=-1).reshape(-1, 2)
    idx = []
    for y in range(H - 1):
        r0 = y * W
        r1 = (y + 1) * W
        for x in range(W - 1):
            idx += [[r0 + x, r0 + x + 1, r1 + x + 1], [r1 + x + 1, r1 + x, r0 + x]]
    mesh = TriMesh(pos, np.asarray(idx, np.int64), None, uv).compute_normals()
    return _finish_mesh(props, ctx, mesh)


# shapegroup/instance: true shared-BLAS instancing
# (``/root/reference/src/shapes/instance.cpp:115-129`` shares one kd-tree per
# shapegroup).  The group's meshes are created ONCE in local space; each
# instance records only a transform — memory is O(unique tris + instances),
# and the two-level hierarchy tests instanced supers with t-preserving
# local-space rays.
_SHAPEGROUPS: dict[str, list] = {}


@register("shape", "shapegroup")
def _shapegroup(props: Properties, ctx=None):
    _SHAPEGROUPS[props.id or "default"] = props.children.get("shape_list", [])
    return None


@register("shape", "instance")
def _instance(props: Properties, ctx=None):
    ref = props.children.get("shapegroup")
    to_world = props.get_transform("toWorld", Transform())
    from ..core import registry

    if ctx is not None and hasattr(ctx, "add_instance"):
        if not isinstance(ref, list):
            if ref in getattr(ctx, "blas_groups", {}):
                # XML path: the <ref> resolved to a captured group key
                ctx.add_instance(ref, np.asarray(to_world.m)[:3, :4])
            return None
        key = id(ref)
        if key not in ctx.blas_groups:
            ctx.begin_group(key)
            for child_props in ref:
                registry.create("shape", child_props.copy(), ctx)
            ctx.end_group(key)
        ctx.add_instance(key, np.asarray(to_world.m)[:3, :4])
        return None
    if not isinstance(ref, list):
        return None
    # no builder context: expand copies (correctness fallback)
    for child_props in ref:
        cp = child_props.copy()
        base = cp.get_transform("toWorld", Transform())
        cp.set("toWorld", to_world @ base)
        registry.create("shape", cp, ctx)
    return None


@register("shape", "deformable")
def _deformable(props: Properties, ctx=None):
    """Keyframed animated mesh (``src/shapes/deformable.cpp`` SpaceTimeKDTree).

    Redesign: instead of a 4D kd-tree (``sahkdtree4.h:113``), the two
    bracketing keyframes are both resident and the *whole wavefront* shares
    one shutter time per pass — vertex positions lerp on device
    (``Scene.with_time``) before tracing, so a progressive render
    stratifies shutter times across passes (equal-quality motion blur with
    zero per-ray machinery).  Frames load from a multi-mesh ``.serialized``
    container (the reference's animation-frame convention); with >2 frames
    the first/last bracket the shutter and intermediate frames are lerped
    piecewise at build (documented simplification).
    """
    path = ctx.resolve_path(props.get_string("filename", ""))
    if not path:
        inner = props.children.get("shape_props")
        if inner is not None:
            from ..core import registry

            return registry.create("shape", inner, ctx)
        return None
    from .mesh import load_serialized, serialized_shape_count

    n_frames = serialized_shape_count(path)
    mesh0 = load_serialized(path, 0)
    mesh1 = load_serialized(path, n_frames - 1) if n_frames > 1 else mesh0
    to_world = props.get_transform("toWorld", Transform())
    mesh0 = mesh0.transformed(to_world)
    mesh1 = mesh1.transformed(to_world)
    if mesh0.normals is None:
        mesh0 = mesh0.compute_normals()
    if mesh1.normals is None:
        mesh1 = mesh1.compute_normals()
    bsdf_id, em_rec, mi, me, ss_id = _shape_common(props, ctx)
    sid = ctx.new_shape(bsdf_id, interior=mi, exterior=me, subsurface=ss_id)
    ctx.add_trimesh_motion(mesh0, mesh1, sid)
    if em_rec is not None:
        e1 = mesh0.positions[mesh0.indices[:, 1]] - mesh0.positions[mesh0.indices[:, 0]]
        e2 = mesh0.positions[mesh0.indices[:, 2]] - mesh0.positions[mesh0.indices[:, 0]]
        area = float(0.5 * np.linalg.norm(np.cross(e1, e2), axis=1).sum())
        _attach_area_emitter(ctx, em_rec, sid, et.AK_TRIMESH,
                             surface_area=area)
    return sid


def load_hair(path: str) -> list[np.ndarray]:
    """Parse a Mitsuba hair file into a list of per-strand (n, 3) arrays.

    Formats per ``/root/reference/src/shapes/hair.cpp``: either the binary
    layout (magic ``BINARY_HAIR``, uint32 total vertex count, float32 xyz
    triples with an ``inf`` x-coordinate sentinel starting a new strand) or
    plain text (one ``x y z`` per line, blank line separates strands).
    """
    with open(path, "rb") as f:
        raw = f.read()
    strands: list[np.ndarray] = []
    cur: list[np.ndarray] = []

    def flush():
        nonlocal cur
        if len(cur) >= 2:
            strands.append(np.asarray(cur, np.float64))
        cur = []

    if raw[:11] == b"BINARY_HAIR":
        n_verts = int(np.frombuffer(raw, "<u4", count=1, offset=11)[0])
        data = np.frombuffer(raw, "<f4", offset=15)
        i = 0
        read = 0
        while read < n_verts and i + 3 <= len(data):
            if np.isinf(data[i]):  # strand break sentinel
                flush()
                i += 1
                continue
            cur.append(np.asarray(data[i : i + 3], np.float64))
            i += 3
            read += 1
        flush()
    else:
        for line in raw.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                flush()
                continue
            parts = line.split()
            if len(parts) >= 3:
                cur.append(np.asarray([float(x) for x in parts[:3]]))
        flush()
    return strands


def tessellate_hair(strands: list[np.ndarray], radius: float,
                    sides: int = 4) -> TriMesh:
    """Tessellate hair strands into watertight view-independent tubes.

    Each strand becomes a generalized cylinder: a ring of ``sides`` vertices
    per control point, frames parallel-transported along the strand so the
    tube never twists, adjacent rings stitched with quads (2 tris each).
    Radial smooth normals reproduce the reference's circular cross-section
    shading (hair.cpp fillIntersectionRecord); the kd-tree-over-segments
    acceleration is subsumed by the generic triangle intersector.
    """
    pos, nrm, idx = [], [], []
    off = 0
    ang = np.arange(sides) * (2.0 * np.pi / sides)
    ca, sa = np.cos(ang), np.sin(ang)
    for strand in strands:
        n = len(strand)
        tang = np.empty_like(strand)
        tang[1:-1] = strand[2:] - strand[:-2]
        tang[0] = strand[1] - strand[0]
        tang[-1] = strand[-1] - strand[-2]
        tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True), 1e-12)
        # parallel-transport an initial frame along the strand
        u = np.cross(tang[0], [0.0, 0.0, 1.0])
        if np.linalg.norm(u) < 1e-6:
            u = np.cross(tang[0], [0.0, 1.0, 0.0])
        u /= np.linalg.norm(u)
        for k in range(n):
            if k > 0:
                # rotate u from tang[k-1] to tang[k] (Rodrigues, small angle)
                axis = np.cross(tang[k - 1], tang[k])
                s = np.linalg.norm(axis)
                c = float(np.dot(tang[k - 1], tang[k]))
                if s > 1e-9:
                    axis = axis / s
                    u = (u * c + np.cross(axis, u) * s
                         + axis * np.dot(axis, u) * (1.0 - c))
            u -= tang[k] * np.dot(u, tang[k])
            u /= max(np.linalg.norm(u), 1e-12)
            w = np.cross(tang[k], u)
            ring_n = np.outer(ca, u) + np.outer(sa, w)     # (sides, 3)
            pos.append(strand[k] + radius * ring_n)
            nrm.append(ring_n)
        for k in range(n - 1):
            a = off + k * sides
            b = a + sides
            for j in range(sides):
                j2 = (j + 1) % sides
                idx.append([a + j, a + j2, b + j2])
                idx.append([b + j2, b + j, a + j])
        off += n * sides
    if not pos:
        raise ValueError("hair file contains no strands")
    return TriMesh(np.concatenate(pos), np.asarray(idx, np.int64),
                   np.concatenate(nrm), None)


@register("shape", "hair")
def _hair(props: Properties, ctx=None):
    """Hair shape (``/root/reference/src/shapes/hair.cpp``): strands loaded
    from the text/binary hair format and tessellated to smooth tubes."""
    path = ctx.resolve_path(props.get_string("filename"))
    radius = props.get_float("radius", 0.025)
    reduction = props.get_float("reduction", 0.0)
    strands = load_hair(path)
    if reduction > 0.0 and strands:
        keep = max(1, int(round(len(strands) * (1.0 - reduction))))
        sel = np.random.default_rng(0).permutation(len(strands))[:keep]
        strands = [strands[i] for i in sorted(sel)]
    mesh = tessellate_hair(strands, radius)
    return _finish_mesh(props, ctx, mesh)
