"""Participating media tables + phase functions.

Parity targets: ``/root/reference/src/medium/homogeneous.cpp`` (closed-form
transmittance + distance sampling), ``heterogeneous.cpp`` (grid-density
media with unbiased free-flight sampling; the reference integrates density
with composite Simpson or samples via its ray-marching scheme — this
build uses **delta/Woodcock tracking** for distance sampling and **ratio
tracking** for transmittance, both branch-free bounded loops over the whole
lane batch), phase functions ``isotropic``/``hg``/``rayleigh``
(``src/phase/``), and the attenuated shadow-ray capability
(``Scene::sampleAttenuatedEmitterDirect``).

Heterogeneous model (heterogeneous.cpp:110-115): sigma_t(x) = scale *
density(x) — spectrally uniform — and sigma_s(x) = sigma_t(x) * albedo(x).
Because sigma_t is gray, delta tracking is *exact*: every accepted
tentative collision is a real collision with weight albedo(x), and
escaping to the surface carries weight 1 (transmittance and pdf cancel).
Density grids live in one flat device atlas; per-medium rows store the
offset/resolution/world-to-voxel affine and the majorant.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int, INVALID
from ..core import math as m
from ..core.math import Frame, vec3, safe_sqrt

PH_ISOTROPIC = 0
PH_HG = 1
PH_RAYLEIGH = 2
PH_KKAY = 3         # Kajiya-Kay fiber phase (src/phase/kkay.cpp)
PH_MICROFLAKE = 4   # Gaussian-fiber microflake (src/phase/microflake.cpp)
PH_MIX = 5          # weighted mixture (src/phase/mixturephase.cpp)

MIX_MAX = 4         # mixture component slots
PHASE_TAB = 32      # per-|cos| normalization table resolution

INV_FOURPI = 1.0 / (4.0 * jnp.pi)


MAX_TRACK_STEPS = 2048  # safety bound on tracking collisions per segment


@pytree_dataclass
class MediumTable:
    sigma_s: jax.Array  # (M, 3) homogeneous scattering coeff (0 for hetero)
    sigma_a: jax.Array  # (M, 3)
    sigma_t: jax.Array  # (M, 3)
    phase_type: jax.Array  # (M,)
    g: jax.Array  # (M,) HG asymmetry
    # -- heterogeneous grid media ------------------------------------------
    hetero: jax.Array  # (M,) int32 0/1
    majorant: jax.Array  # (M,) max sigma_t over the grid (scale folded in)
    grid_offset: jax.Array  # (M,) int32 into density_atlas
    grid_res: jax.Array  # (M, 3) int32 (nx, ny, nz)
    w2g: jax.Array  # (M, 12) rows of world->voxel affine
    albedo_c: jax.Array  # (M, 3) constant single-scattering albedo
    alb_offset: jax.Array  # (M,) int32 into albedo_atlas, -1 = constant
    alb_res: jax.Array  # (M, 3) int32
    alb_w2g: jax.Array  # (M, 12)
    density_atlas: jax.Array  # (D,) f32 sigma_t values (scale * density)
    albedo_atlas: jax.Array  # (A, 3) f32
    # -- structured phase functions (kkay / microflake / mixture) ----------
    ph_kd: jax.Array  # (M,) kkay diffuse weight
    ph_ks: jax.Array  # (M,) kkay specular weight
    ph_exp: jax.Array  # (M,) kkay specular exponent
    ph_c: jax.Array  # (M,) microflake D(m) normalization constant
    ph_inv2s2: jax.Array  # (M,) microflake 1/(2 stddev^2)
    ph_tab: jax.Array  # (M*PHASE_TAB,) flat per-|cos| table:
    #   microflake -> projected flake area sigma(c); kkay -> integral of the
    #   unnormalized lobe over the sphere; 1 otherwise
    mix_type: jax.Array  # (M, MIX_MAX) int32 component phase types
    mix_g: jax.Array  # (M, MIX_MAX)
    mix_w: jax.Array  # (M, MIX_MAX) weights (0 in unused slots)
    # -- orientation volumes (fiber axis for kkay/microflake) --------------
    ori_offset: jax.Array  # (M,) int32 into orientation_atlas, -1 = none
    ori_res: jax.Array  # (M, 3) int32
    ori_w2g: jax.Array  # (M, 12)
    orientation_atlas: jax.Array  # (O, 3)
    n_media: int = static_field(default=0)
    used_phase: tuple = static_field(default=())
    has_hetero: bool = static_field(default=False)
    has_fancy_phase: bool = static_field(default=False)

    @property
    def any(self):
        return self.n_media > 0


def _pack_grid(atlas: list, rec: dict) -> tuple[int, np.ndarray, np.ndarray]:
    """Append a grid record's data to the atlas list; returns
    (offset, res[3], w2g rows[12])."""
    from .volume import grid_world_to_voxel

    data = np.asarray(rec["data"], np.float32)
    zres, yres, xres, _ = data.shape
    off = sum(a.shape[0] for a in atlas)  # row offset (atlas rows are (C,))
    atlas.append(data.reshape(-1, data.shape[-1]))
    m = grid_world_to_voxel(rec)[:3, :]  # 3x4 rows
    return off, np.asarray([xres, yres, zres], np.int32), m.reshape(12)


# ---------------------------------------------------------------------------
# Host-side phase precomputation (microflake sigma / kkay normalization)
# ---------------------------------------------------------------------------

def _flake_norm_const(stddev: float) -> float:
    """Normalization C of D(m) = C exp(-(m.a)^2 / (2 s^2)) over the sphere:
    flake normals concentrated on the equator w.r.t. the fiber axis a (the
    Gaussian fiber distribution of microflake.cpp)."""
    import math

    s = max(float(stddev), 1e-4)
    integral = 2.0 * np.pi * s * math.sqrt(2.0 * np.pi) * math.erf(
        1.0 / (s * math.sqrt(2.0)))
    return 1.0 / integral


def _flake_sigma_table(stddev: float, K: int = PHASE_TAB) -> np.ndarray:
    """Projected flake area sigma(c) = int D(m) |w.m| dm as a function of
    c = |w.a| (azimuthal symmetry), by Gauss-Legendre x uniform-phi
    quadrature.  The reference expands this in Chebyshev series
    (microflake_fiber.h); a 32-entry lerp table is equivalent here."""
    s = max(float(stddev), 1e-4)
    C = _flake_norm_const(s)
    t, wt = np.polynomial.legendre.leggauss(128)       # cos-theta over m
    phi = (np.arange(64) + 0.5) * (2.0 * np.pi / 64)
    st = np.sqrt(np.maximum(1.0 - t * t, 0.0))
    mx = st[:, None] * np.cos(phi)[None, :]
    mz = np.broadcast_to(t[:, None], mx.shape)
    D = C * np.exp(-(mz ** 2) / (2.0 * s * s))
    cs = np.linspace(0.0, 1.0, K)
    out = np.empty(K)
    for i, c in enumerate(cs):
        sw = np.sqrt(max(1.0 - c * c, 0.0))
        dot = np.abs(mx * sw + mz * c)                  # w = (sw, 0, c)
        out[i] = float(np.sum(D * dot * wt[:, None]) * (2.0 * np.pi / 64))
    return out


def _kkay_norm_table(kd: float, ks: float, expo: float,
                     K: int = PHASE_TAB) -> np.ndarray:
    """Sphere integral of the unnormalized Kajiya-Kay lobe as a function of
    c = |cos(axis, w_in)| (the reference normalizes by a single Simpson
    integral at theta_i = pi/2, kkay.cpp:60-70; normalizing per incident
    angle keeps the phase function exactly energy-conserving)."""
    x, wt = np.polynomial.legendre.leggauss(256)
    cs = np.linspace(0.0, 1.0, K)
    out = np.empty(K)
    for i, c in enumerate(cs):
        si = np.sqrt(max(1.0 - c * c, 0.0))
        spec = np.maximum(c * x + si * np.sqrt(np.maximum(1 - x * x, 0)), 0.0)
        lobe = kd + ks * np.where(spec > 0, spec ** max(expo, 0.0), 0.0)
        out[i] = float(2.0 * np.pi * np.sum(lobe * wt))
    return np.maximum(out, 1e-9)


def _parse_phase(ph: dict):
    """Flatten a phase record -> per-medium scalar rows + mixture slots."""
    ptype = int(ph.get("type", PH_ISOTROPIC))
    row = dict(type=ptype, g=float(ph.get("g", 0.0)),
               kd=0.0, ks=0.0, exp=1.0, c=0.0, inv2s2=0.0,
               tab=np.ones(PHASE_TAB),
               mix_type=np.zeros(MIX_MAX, np.int32),
               mix_g=np.zeros(MIX_MAX), mix_w=np.zeros(MIX_MAX))
    if ptype == PH_KKAY:
        row["kd"] = float(ph.get("kd", 0.2))
        row["ks"] = float(ph.get("ks", 0.4))
        row["exp"] = float(ph.get("exponent", 4.0))
        row["tab"] = _kkay_norm_table(row["kd"], row["ks"], row["exp"])
    elif ptype == PH_MICROFLAKE:
        s = float(ph.get("stddev", 0.3))
        row["c"] = _flake_norm_const(s)
        row["inv2s2"] = 1.0 / (2.0 * max(s, 1e-4) ** 2)
        row["tab"] = _flake_sigma_table(s)
    elif ptype == PH_MIX:
        comps = ph.get("components", [])[:MIX_MAX]
        for k, (w, sub) in enumerate(comps):
            st = int(sub.get("type", PH_ISOTROPIC))
            if st not in (PH_ISOTROPIC, PH_HG, PH_RAYLEIGH):
                raise ValueError(
                    "mixturephase components must be isotropic/hg/rayleigh")
            row["mix_type"][k] = st
            row["mix_g"][k] = float(sub.get("g", 0.0))
            row["mix_w"][k] = float(w)
        tot = row["mix_w"].sum()
        if tot > 1.0 + 1e-6:
            raise ValueError("mixturephase weights must sum to <= 1")
        if tot <= 0:
            row["mix_type"][0] = PH_ISOTROPIC
            row["mix_w"][0] = 1.0
    return row


def build_media(records: list[dict]) -> MediumTable:
    recs = records or [dict(sigma_s=np.zeros(3), sigma_a=np.zeros(3), scale=1.0,
                            phase=dict(type=PH_ISOTROPIC, g=0.0))]
    M = len(recs)
    ss = np.zeros((M, 3))
    sa = np.zeros((M, 3))
    ph_rows = [_parse_phase(r.get("phase", {}) or {}) for r in recs]
    pt = np.asarray([p["type"] for p in ph_rows], np.int32)
    g = np.asarray([p["g"] for p in ph_rows], np.float64)

    hetero = np.zeros(M, np.int32)
    majorant = np.zeros(M, np.float64)
    goff = np.zeros(M, np.int32)
    gres = np.ones((M, 3), np.int32)
    w2g = np.tile(np.eye(4)[:3, :].reshape(12), (M, 1))
    alb_c = np.full((M, 3), 0.8)
    aoff = np.full(M, -1, np.int32)
    ares = np.ones((M, 3), np.int32)
    aw2g = np.tile(np.eye(4)[:3, :].reshape(12), (M, 1))
    ooff = np.full(M, -1, np.int32)
    ores = np.ones((M, 3), np.int32)
    ow2g = np.tile(np.eye(4)[:3, :].reshape(12), (M, 1))
    d_atlas: list = []
    a_atlas: list = []
    o_atlas: list = []

    for i, r in enumerate(recs):
        scale = r.get("scale", 1.0)
        if r.get("kind") == "heterogeneous":
            dg = r.get("density")
            if dg is None:
                continue
            dg = dict(dg)
            dg["data"] = np.asarray(dg["data"], np.float32)[..., :1] * scale
            hetero[i] = 1
            majorant[i] = float(dg["data"].max(initial=0.0))
            goff[i], gres[i], w2g[i] = _pack_grid(d_atlas, dg)
            ag = r.get("albedo")
            if ag is not None:
                adata = np.asarray(ag["data"], np.float32)
                if adata.shape[-1] == 1:
                    adata = np.repeat(adata, 3, axis=-1)
                if ag.get("const") or adata.size <= 3:
                    alb_c[i] = adata.reshape(-1, 3)[0]
                else:
                    ag = dict(ag, data=adata)
                    aoff[i], ares[i], aw2g[i] = _pack_grid(a_atlas, ag)
            og = r.get("orientation")
            if og is not None:
                odata = np.asarray(og["data"], np.float32)
                if odata.shape[-1] == 3 and odata.size > 3:
                    og = dict(og, data=odata)
                    ooff[i], ores[i], ow2g[i] = _pack_grid(o_atlas, og)
        else:
            ss[i] = np.asarray(r["sigma_s"], np.float64) * scale
            sa[i] = np.asarray(r["sigma_a"], np.float64) * scale

    dens = (np.concatenate(d_atlas, axis=0)[:, 0] if d_atlas
            else np.zeros(1, np.float32))
    alb = (np.concatenate(a_atlas, axis=0) if a_atlas
           else np.zeros((1, 3), np.float32))
    ori = (np.concatenate(o_atlas, axis=0) if o_atlas
           else np.zeros((1, 3), np.float32))
    fancy = {PH_KKAY, PH_MICROFLAKE, PH_MIX} & set(int(x) for x in pt)
    return MediumTable(
        sigma_s=jnp.asarray(ss, Float), sigma_a=jnp.asarray(sa, Float),
        sigma_t=jnp.asarray(ss + sa, Float),
        phase_type=jnp.asarray(pt, Int), g=jnp.asarray(g, Float),
        hetero=jnp.asarray(hetero, Int), majorant=jnp.asarray(majorant, Float),
        grid_offset=jnp.asarray(goff, Int), grid_res=jnp.asarray(gres, Int),
        w2g=jnp.asarray(w2g, Float),
        albedo_c=jnp.asarray(alb_c, Float),
        alb_offset=jnp.asarray(aoff, Int), alb_res=jnp.asarray(ares, Int),
        alb_w2g=jnp.asarray(aw2g, Float),
        density_atlas=jnp.asarray(dens, Float),
        albedo_atlas=jnp.asarray(alb, Float),
        ph_kd=jnp.asarray([p["kd"] for p in ph_rows], Float),
        ph_ks=jnp.asarray([p["ks"] for p in ph_rows], Float),
        ph_exp=jnp.asarray([p["exp"] for p in ph_rows], Float),
        ph_c=jnp.asarray([p["c"] for p in ph_rows], Float),
        ph_inv2s2=jnp.asarray([p["inv2s2"] for p in ph_rows], Float),
        ph_tab=jnp.asarray(
            np.concatenate([p["tab"] for p in ph_rows]), Float),
        mix_type=jnp.asarray(np.stack([p["mix_type"] for p in ph_rows]), Int),
        mix_g=jnp.asarray(np.stack([p["mix_g"] for p in ph_rows]), Float),
        mix_w=jnp.asarray(np.stack([p["mix_w"] for p in ph_rows]), Float),
        ori_offset=jnp.asarray(ooff, Int), ori_res=jnp.asarray(ores, Int),
        ori_w2g=jnp.asarray(ow2g, Float),
        orientation_atlas=jnp.asarray(ori, Float),
        n_media=len(records),
        used_phase=tuple(sorted(set(int(x) for x in pt))),
        has_hetero=bool(hetero.any()),
        has_fancy_phase=bool(fancy),
    )


def medium_params(media: MediumTable, mid: jax.Array):
    """Per-lane (sigma_s, sigma_t, phase_type, g); vacuum for INVALID."""
    from ..core.gather import RowBundle

    idx = jnp.where(mid == INVALID, 0, mid)
    b = (
        RowBundle()
        .add("sigma_s", media.sigma_s).add("sigma_t", media.sigma_t)
        .add("phase_type", media.phase_type).add("g", media.g)
    ).lookup(idx)
    vac = (mid == INVALID)[..., None]
    return (
        jnp.where(vac, 0.0, b["sigma_s"]),
        jnp.where(vac, 0.0, b["sigma_t"]),
        b["phase_type"],
        b["g"],
    )


def hetero_rows(media: MediumTable, mid: jax.Array) -> dict:
    """Per-lane heterogeneous-medium rows (vacuum-safe)."""
    from ..core.gather import RowBundle

    idx = jnp.where(mid == INVALID, 0, mid)
    b = (
        RowBundle()
        .add("hetero", media.hetero).add("majorant", media.majorant)
        .add("grid_res", media.grid_res)
        .add("w2g", media.w2g)
        .add("albedo_c", media.albedo_c)
        .add("alb_res", media.alb_res)
        .add("alb_w2g", media.alb_w2g)
    ).lookup(idx)
    # atlas offsets can exceed 2^24: keep them exact int gathers, not the
    # f32-packed bundle
    b["grid_offset"] = media.grid_offset[idx]
    b["alb_offset"] = media.alb_offset[idx]
    b["is_het"] = (mid != INVALID) & (b["hetero"] > 0)
    return b


def _trilinear(atlas, offset, res, w2g, p):
    """Trilinear grid lookup. atlas (D,) or (D,C); offset (n,), res (n,3)
    int, w2g (n,12) affine rows; p (n,3) world points. Zero outside."""
    rows = w2g.reshape(w2g.shape[:-1] + (3, 4))
    gpt = jnp.einsum("...ij,...j->...i", rows[..., :3], p,
                     precision=jax.lax.Precision.HIGHEST) + rows[..., 3]
    resf = res.astype(Float)
    inside = jnp.all((gpt >= 0.0) & (gpt <= resf - 1.0 + 1e-4), axis=-1)
    gc = jnp.clip(gpt, 0.0, jnp.maximum(resf - 1.0, 0.0))
    i0 = jnp.floor(gc).astype(Int)
    i0 = jnp.minimum(i0, jnp.maximum(res - 2, 0))
    f = gc - i0.astype(Float)
    i1 = jnp.minimum(i0 + 1, res - 1)
    nx, ny = res[..., 0], res[..., 1]

    def at(ix, iy, iz):
        flat = offset + ((iz * ny + iy) * nx + ix)
        return atlas[flat]

    def lerp(a, b, t):
        if a.ndim > t.ndim:
            t = t[..., None]
        return a + (b - a) * t

    x0, x1 = i0[..., 0], i1[..., 0]
    y0, y1 = i0[..., 1], i1[..., 1]
    z0, z1 = i0[..., 2], i1[..., 2]
    c00 = lerp(at(x0, y0, z0), at(x1, y0, z0), f[..., 0])
    c10 = lerp(at(x0, y1, z0), at(x1, y1, z0), f[..., 0])
    c01 = lerp(at(x0, y0, z1), at(x1, y0, z1), f[..., 0])
    c11 = lerp(at(x0, y1, z1), at(x1, y1, z1), f[..., 0])
    c0 = lerp(c00, c10, f[..., 1])
    c1 = lerp(c01, c11, f[..., 1])
    val = lerp(c0, c1, f[..., 2])
    if val.ndim > inside.ndim:
        inside = inside[..., None]
    return jnp.where(inside, val, 0.0)


def sigma_t_at(media: MediumTable, rows: dict, p: jax.Array) -> jax.Array:
    """Heterogeneous sigma_t (= scale*density, gray) at world points."""
    return _trilinear(media.density_atlas, rows["grid_offset"],
                      rows["grid_res"], rows["w2g"], p)


def albedo_at(media: MediumTable, rows: dict, p: jax.Array) -> jax.Array:
    """Single-scattering albedo at world points; constant fallback."""
    grid = _trilinear(media.albedo_atlas, jnp.maximum(rows["alb_offset"], 0),
                      rows["alb_res"], rows["alb_w2g"], p)
    return jnp.where((rows["alb_offset"] >= 0)[..., None], grid, rows["albedo_c"])


def track_distance(media: MediumTable, rows: dict, o, d, t_max, s, active):
    """Delta/Woodcock tracking through heterogeneous lanes.

    Returns (sampler, t_event, scattered).  Exact because sigma_t is gray
    (heterogeneous.cpp model): accepted collisions carry weight albedo(x),
    escapes carry weight 1.
    """
    from ..core import rng as mrng

    n = o.shape[0]
    maj = jnp.maximum(rows["majorant"], 1e-20)
    live0 = active & rows["is_het"] & (rows["majorant"] > 1e-20)

    def cond(st):
        i, s_, t, live, sc = st
        return (i < MAX_TRACK_STEPS) & jnp.any(live)

    def body(st):
        i, s_, t, live, sc = st
        s_, blk = mrng.next_block4(s_)
        step = -jnp.log1p(-jnp.minimum(blk[..., 0], 0.999999)) / maj
        t2 = t + step
        esc = t2 >= t_max
        p = o + d * t2[..., None]
        dens = sigma_t_at(media, rows, p)
        accept = blk[..., 1] < dens / maj
        sc = sc | (live & ~esc & accept)
        t = jnp.where(live, jnp.minimum(t2, t_max), t)
        live = live & ~esc & ~accept
        return (i + 1, s_, t, live, sc)

    init = (jnp.zeros((), Int), s, jnp.zeros((n,), Float), live0,
            jnp.zeros((n,), bool))
    _, s, t, _, scattered = jax.lax.while_loop(cond, body, init)
    return s, t, scattered


def track_transmittance(media: MediumTable, rows: dict, o, d, dist, s, active):
    """Ratio tracking: unbiased transmittance estimate along shadow
    segments through heterogeneous lanes. Returns (sampler, T scalar)."""
    from ..core import rng as mrng

    n = o.shape[0]
    maj = jnp.maximum(rows["majorant"], 1e-20)
    live0 = active & rows["is_het"] & (rows["majorant"] > 1e-20)

    def cond(st):
        i, s_, t, T, live = st
        return (i < MAX_TRACK_STEPS) & jnp.any(live)

    def body(st):
        i, s_, t, T, live = st
        s_, blk = mrng.next_block4(s_)
        step = -jnp.log1p(-jnp.minimum(blk[..., 0], 0.999999)) / maj
        t2 = t + step
        esc = t2 >= dist
        p = o + d * t2[..., None]
        dens = sigma_t_at(media, rows, p)
        T = jnp.where(live & ~esc, T * (1.0 - dens / maj), T)
        t = jnp.where(live, t2, t)
        live = live & ~esc & (T > 1e-6)
        return (i + 1, s_, t, T, live)

    init = (jnp.zeros((), Int), s, jnp.zeros((n,), Float),
            jnp.ones((n,), Float), live0)
    _, s, _, T, live = jax.lax.while_loop(cond, body, init)
    T = jnp.where(live, 0.0, jnp.maximum(T, 0.0))  # budget exceeded: opaque
    return s, T


def transmittance(sigma_t: jax.Array, dist: jax.Array) -> jax.Array:
    """Homogeneous Beer-Lambert transmittance; (..., 3)."""
    return jnp.exp(-sigma_t * jnp.minimum(dist, 1e30)[..., None])


def sample_distance(sigma_t: jax.Array, u: jax.Array):
    """Channel-averaged free-flight sampling.

    Returns (t, pdf_continue(t), pdf_surface = P[t' > t_surf]-density form):
    callers compare t with the surface distance; weights follow the
    standard homogeneous estimator (homogeneous.cpp sampleDistance).
    """
    st_bar = jnp.maximum(jnp.mean(sigma_t, axis=-1), 1e-20)
    t = -jnp.log(jnp.maximum(1.0 - u, 1e-20)) / st_bar
    return t, st_bar


# ---------------------------------------------------------------------------
# Component-SoA API (canonical for the wavefront hot path)
# ---------------------------------------------------------------------------

def medium_params_v(media: MediumTable, mid: jax.Array):
    """SoA per-lane (sigma_s V3, sigma_t V3, phase_type, g)."""
    from ..core import v3 as v

    idx = jnp.where(mid == INVALID, 0, mid)
    vac = mid == INVALID
    z = jnp.zeros(mid.shape, Float)
    zero = v.V3(z, z, z)
    ss = v.where(vac, zero, v.gather_v3(media.sigma_s, idx))
    st = v.where(vac, zero, v.gather_v3(media.sigma_t, idx))
    return ss, st, v.gather_col(media.phase_type, idx), v.gather_col(media.g, idx)


def hetero_rows_v(media: MediumTable, mid: jax.Array) -> dict:
    """SoA heterogeneous rows: affines as 12 flat columns."""
    from ..core import v3 as v

    idx = jnp.where(mid == INVALID, 0, mid)
    b = dict(
        hetero=v.gather_col(media.hetero, idx),
        majorant=v.gather_col(media.majorant, idx),
        grid_res=tuple(v.gather_col(media.grid_res[:, k], idx) for k in range(3)),
        w2g=tuple(v.gather_col(media.w2g[:, k], idx) for k in range(12)),
        albedo_c=v.gather_v3(media.albedo_c, idx),
        alb_res=tuple(v.gather_col(media.alb_res[:, k], idx) for k in range(3)),
        alb_w2g=tuple(v.gather_col(media.alb_w2g[:, k], idx) for k in range(12)),
        grid_offset=media.grid_offset[idx],
        alb_offset=media.alb_offset[idx],
    )
    b["is_het"] = (mid != INVALID) & (b["hetero"] > 0)
    return b


def _trilinear_v(atlas, offset, res, w2g, p, vec_out: bool):
    """SoA trilinear grid lookup: res/w2g are column tuples, p is V3."""
    from ..core import v3 as v

    r = w2g
    gx = r[0] * p.x + r[1] * p.y + r[2] * p.z + r[3]
    gy = r[4] * p.x + r[5] * p.y + r[6] * p.z + r[7]
    gz = r[8] * p.x + r[9] * p.y + r[10] * p.z + r[11]
    nx, ny, nz = res
    fx = nx.astype(Float) - 1.0
    fy = ny.astype(Float) - 1.0
    fz = nz.astype(Float) - 1.0
    inside = ((gx >= 0.0) & (gx <= fx + 1e-4) & (gy >= 0.0)
              & (gy <= fy + 1e-4) & (gz >= 0.0) & (gz <= fz + 1e-4))
    gx = jnp.clip(gx, 0.0, jnp.maximum(fx, 0.0))
    gy = jnp.clip(gy, 0.0, jnp.maximum(fy, 0.0))
    gz = jnp.clip(gz, 0.0, jnp.maximum(fz, 0.0))
    x0 = jnp.minimum(jnp.floor(gx).astype(Int), jnp.maximum(nx - 2, 0))
    y0 = jnp.minimum(jnp.floor(gy).astype(Int), jnp.maximum(ny - 2, 0))
    z0 = jnp.minimum(jnp.floor(gz).astype(Int), jnp.maximum(nz - 2, 0))
    tx = gx - x0.astype(Float)
    ty = gy - y0.astype(Float)
    tz = gz - z0.astype(Float)
    x1 = jnp.minimum(x0 + 1, nx - 1)
    y1 = jnp.minimum(y0 + 1, ny - 1)
    z1 = jnp.minimum(z0 + 1, nz - 1)

    def at(ix, iy, iz):
        flat = offset + ((iz * ny + iy) * nx + ix)
        if vec_out:
            return v.V3.from_array(atlas[flat])
        return atlas[flat]

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(at(x0, y0, z0), at(x1, y0, z0), tx)
    c10 = lerp(at(x0, y1, z0), at(x1, y1, z0), tx)
    c01 = lerp(at(x0, y0, z1), at(x1, y0, z1), tx)
    c11 = lerp(at(x0, y1, z1), at(x1, y1, z1), tx)
    val = lerp(lerp(c00, c10, ty), lerp(c01, c11, ty), tz)
    if vec_out:
        return v.where(inside, val, v.V3(jnp.zeros_like(gx),
                                         jnp.zeros_like(gx),
                                         jnp.zeros_like(gx)))
    return jnp.where(inside, val, 0.0)


def sigma_t_at_v(media: MediumTable, rows: dict, p) -> jax.Array:
    return _trilinear_v(media.density_atlas, rows["grid_offset"],
                        rows["grid_res"], rows["w2g"], p, vec_out=False)


def albedo_at_v(media: MediumTable, rows: dict, p):
    from ..core import v3 as v

    grid = _trilinear_v(media.albedo_atlas, jnp.maximum(rows["alb_offset"], 0),
                        rows["alb_res"], rows["alb_w2g"], p, vec_out=True)
    return v.where(rows["alb_offset"] >= 0, grid, rows["albedo_c"])


def track_distance_v(media: MediumTable, rows: dict, o, d, t_max, s, active):
    """SoA delta/Woodcock tracking; o, d are V3, sampler is Sampler3."""
    from ..core import rng as mrng

    n = o.x.shape[0]
    maj = jnp.maximum(rows["majorant"], 1e-20)
    live0 = active & rows["is_het"] & (rows["majorant"] > 1e-20)

    def cond(st):
        i, s_, t, live, sc = st
        return (i < MAX_TRACK_STEPS) & jnp.any(live)

    def body(st):
        i, s_, t, live, sc = st
        s_, blk = mrng.next_block4_v(s_)
        step = -jnp.log1p(-jnp.minimum(blk[0], 0.999999)) / maj
        t2 = t + step
        esc = t2 >= t_max
        p = o + d * t2
        dens = sigma_t_at_v(media, rows, p)
        accept = blk[1] < dens / maj
        sc = sc | (live & ~esc & accept)
        t = jnp.where(live, jnp.minimum(t2, t_max), t)
        live = live & ~esc & ~accept
        return (i + 1, s_, t, live, sc)

    init = (jnp.zeros((), Int), s, jnp.zeros((n,), Float), live0,
            jnp.zeros((n,), bool))
    _, s, t, _, scattered = jax.lax.while_loop(cond, body, init)
    return s, t, scattered


def track_transmittance_v(media: MediumTable, rows: dict, o, d, dist, s,
                          active):
    """SoA ratio tracking; returns (sampler, T scalar)."""
    from ..core import rng as mrng

    n = o.x.shape[0]
    maj = jnp.maximum(rows["majorant"], 1e-20)
    live0 = active & rows["is_het"] & (rows["majorant"] > 1e-20)

    def cond(st):
        i, s_, t, T, live = st
        return (i < MAX_TRACK_STEPS) & jnp.any(live)

    def body(st):
        i, s_, t, T, live = st
        s_, blk = mrng.next_block4_v(s_)
        step = -jnp.log1p(-jnp.minimum(blk[0], 0.999999)) / maj
        t2 = t + step
        esc = t2 >= dist
        p = o + d * t2
        dens = sigma_t_at_v(media, rows, p)
        T = jnp.where(live & ~esc, T * (1.0 - dens / maj), T)
        t = jnp.where(live, t2, t)
        live = live & ~esc & (T > 1e-6)
        return (i + 1, s_, t, T, live)

    init = (jnp.zeros((), Int), s, jnp.zeros((n,), Float),
            jnp.ones((n,), Float), live0)
    _, s, _, T, live = jax.lax.while_loop(cond, body, init)
    T = jnp.where(live, 0.0, jnp.maximum(T, 0.0))  # budget exceeded: opaque
    return s, T


def transmittance_v(sigma_t, dist):
    """SoA Beer-Lambert; sigma_t V3, dist (N,) -> V3."""
    d = jnp.minimum(dist, 1e30)
    return (sigma_t * (-d)).exp()


def sample_distance_v(sigma_t, u: jax.Array):
    """SoA channel-averaged free flight: sigma_t V3 -> (t, st_bar)."""
    st_bar = jnp.maximum(sigma_t.mean(), 1e-20)
    t = -jnp.log(jnp.maximum(1.0 - u, 1e-20)) / st_bar
    return t, st_bar


def phase_eval_v(ptype, g, wi, wo):
    """SoA p(wi -> wo); wi, wo are V3."""
    cos_theta = (-wi).dot(wo)
    iso = jnp.full(cos_theta.shape, INV_FOURPI)
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    hg = INV_FOURPI * (1.0 - g * g) / jnp.maximum(
        denom * safe_sqrt(denom), 1e-8)
    ray = (3.0 / (16.0 * jnp.pi)) * (1.0 + cos_theta * cos_theta)
    out = iso
    out = jnp.where(ptype == PH_HG, hg, out)
    out = jnp.where(ptype == PH_RAYLEIGH, ray, out)
    return out


def phase_sample_v(ptype, g, wi, u1, u2):
    """SoA phase sampling; returns (wo V3, pdf)."""
    from ..core import v3 as v

    wo_iso = v.square_to_uniform_sphere(u1, u2)

    safe_g = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
    cos_hg = (1.0 + g * g - sqr * sqr) / (2.0 * safe_g)
    cos_hg = jnp.where(jnp.abs(g) < 1e-4, 1.0 - 2.0 * u1, cos_hg)
    cos_hg = jnp.clip(cos_hg, -1.0, 1.0)
    sin_hg = safe_sqrt(1.0 - cos_hg * cos_hg)
    phi = 2.0 * jnp.pi * u2
    frame = v.frame_from_normal(-wi)
    wo_hg = v.to_world(
        frame, v.V3(sin_hg * jnp.cos(phi), sin_hg * jnp.sin(phi), cos_hg))

    z = 2.0 * (2.0 * u1 - 1.0)
    A = jnp.cbrt(z + jnp.sqrt(z * z + 1.0))
    cos_r = jnp.clip(A - 1.0 / A, -1.0, 1.0)
    sin_r = safe_sqrt(1.0 - cos_r * cos_r)
    wo_ray = v.to_world(
        frame, v.V3(sin_r * jnp.cos(phi), sin_r * jnp.sin(phi), cos_r))

    wo = wo_iso
    wo = v.where(ptype == PH_HG, wo_hg, wo)
    wo = v.where(ptype == PH_RAYLEIGH, wo_ray, wo)
    return wo, phase_eval_v(ptype, g, wi, wo)


# ---------------------------------------------------------------------------
# Structured phase functions: kkay / microflake / mixture (SoA, ctx-based)
#
# ``wi`` is the propagation direction INTO the collision (matching
# phase_eval_v). The fiber axis comes from the medium's orientation volume
# at the scatter point (heterogeneous.cpp 'orientation' child), falling
# back to +z.  All three integrate to exactly 1 over wo (mixture: to the
# weight total), verified by the chi2/quadrature tests.
# ---------------------------------------------------------------------------

def orientation_at_v(media: MediumTable, mid: jax.Array, p):
    """Fiber axis at world points p (V3): normalized orientation-volume
    lookup, +z where the medium has no orientation data or the local
    vector vanishes."""
    from ..core import v3 as v

    idx = jnp.where(mid == INVALID, 0, mid)
    off = media.ori_offset[idx]
    res = tuple(v.gather_col(media.ori_res[:, k], idx) for k in range(3))
    w2g = tuple(v.gather_col(media.ori_w2g[:, k], idx) for k in range(12))
    vec = _trilinear_v(media.orientation_atlas, jnp.maximum(off, 0),
                       res, w2g, p, vec_out=True)
    ln = vec.norm()
    ok = (off >= 0) & (ln > 1e-6)
    z = jnp.zeros_like(ln)
    fallback = v.V3(z, z, jnp.ones_like(ln))
    return v.where(ok, vec * (1.0 / jnp.maximum(ln, 1e-6)), fallback)


def _tab_interp_v(tab_flat, mid, c):
    """Lerp into the per-medium (PHASE_TAB,) tables over |c| in [0,1]."""
    cc = jnp.clip(jnp.abs(c), 0.0, 1.0) * (PHASE_TAB - 1)
    j0 = jnp.minimum(jnp.floor(cc).astype(Int), PHASE_TAB - 2)
    f = cc - j0.astype(Float)
    base = mid * PHASE_TAB
    a = tab_flat[base + j0]
    b = tab_flat[base + j0 + 1]
    return a + (b - a) * f


def phase_ctx_v(media: MediumTable, mid: jax.Array, p) -> dict:
    """Per-lane phase context at scatter points p; cheap (type/g only)
    when the scene has no structured phases (static gating)."""
    from ..core import v3 as v

    idx = jnp.where(mid == INVALID, 0, mid)
    ctx = dict(
        mid=idx,
        ptype=v.gather_col(media.phase_type, idx),
        g=v.gather_col(media.g, idx),
    )
    if media.has_fancy_phase:
        ctx.update(
            kd=v.gather_col(media.ph_kd, idx),
            ks=v.gather_col(media.ph_ks, idx),
            exp=v.gather_col(media.ph_exp, idx),
            fc=v.gather_col(media.ph_c, idx),
            inv2s2=v.gather_col(media.ph_inv2s2, idx),
            mix_type=tuple(v.gather_col(media.mix_type[:, k], idx)
                           for k in range(MIX_MAX)),
            mix_g=tuple(v.gather_col(media.mix_g[:, k], idx)
                        for k in range(MIX_MAX)),
            mix_w=tuple(v.gather_col(media.mix_w[:, k], idx)
                        for k in range(MIX_MAX)),
            axis=orientation_at_v(media, mid, p),
        )
    return ctx


def _kkay_lobe(ctx, wi, wo):
    """Unnormalized Kajiya-Kay lobe kd + ks cos^e(theta_i - theta_o)."""
    axis = ctx["axis"]
    u = (-wi).dot(axis)
    vv = wo.dot(axis)
    si = safe_sqrt(1.0 - u * u)
    so = safe_sqrt(1.0 - vv * vv)
    spec = jnp.maximum(u * vv + si * so, 0.0)
    e = jnp.maximum(ctx["exp"], 0.0)
    return ctx["kd"] + ctx["ks"] * jnp.where(
        spec > 0, jnp.exp(e * jnp.log(jnp.maximum(spec, 1e-20))), 0.0)


def _flake_D(ctx, t):
    """Gaussian fiber-normal distribution D(m) at t = m.axis."""
    return ctx["fc"] * jnp.exp(-t * t * ctx["inv2s2"])


def _mix_eval(ctx, wi, wo):
    out = jnp.zeros(wi.x.shape, Float)
    for k in range(MIX_MAX):
        out = out + ctx["mix_w"][k] * phase_eval_v(
            ctx["mix_type"][k], ctx["mix_g"][k], wi, wo)
    return out


def phase_eval_ctx_v(media: MediumTable, ctx: dict, wi, wo):
    """p(wi -> wo) with full dispatch over the scene's phase set."""
    val = phase_eval_v(ctx["ptype"], ctx["g"], wi, wo)
    if not media.has_fancy_phase:
        return val
    axis = ctx["axis"]
    ptype = ctx["ptype"]
    # kkay: per-incident-angle normalized lobe
    norm = _tab_interp_v(media.ph_tab, ctx["mid"], (-wi).dot(axis))
    kk = _kkay_lobe(ctx, wi, wo) / norm
    # microflake: D(h)/(2 sigma(w)); h = the mirror flake normal.  The
    # reflection map m -> wo is 2-to-1 (antipodal flakes coincide), so the
    # change of variables gives  int D(h) dwo = 2 sigma(w).
    h = wo - wi
    hl = jnp.maximum(h.norm(), 1e-8)
    hn = h * (1.0 / hl)
    sigma = _tab_interp_v(media.ph_tab, ctx["mid"], wi.dot(axis))
    mf = _flake_D(ctx, hn.dot(axis)) / (2.0 * jnp.maximum(sigma, 1e-8))
    mix = _mix_eval(ctx, wi, wo)
    out = val
    out = jnp.where(ptype == PH_KKAY, kk, out)
    out = jnp.where(ptype == PH_MICROFLAKE, mf, out)
    out = jnp.where(ptype == PH_MIX, mix, out)
    return out


def phase_pdf_ctx_v(media: MediumTable, ctx: dict, wi, wo):
    """pdf of :func:`phase_sample_ctx_v` producing wo (for MIS)."""
    pdf = phase_eval_v(ctx["ptype"], ctx["g"], wi, wo)  # value-prop sampling
    if not media.has_fancy_phase:
        return pdf
    ptype = ctx["ptype"]
    axis = ctx["axis"]
    # kkay samples the uniform sphere
    kk = jnp.full(pdf.shape, INV_FOURPI)
    # microflake samples m ~ D then mirrors: pdf = D(h) / (2 |wi.h|)
    h = wo - wi
    hl = jnp.maximum(h.norm(), 1e-8)
    hn = h * (1.0 / hl)
    mf = _flake_D(ctx, hn.dot(axis)) / (
        2.0 * jnp.maximum(jnp.abs(wi.dot(hn)), 1e-6))
    mix_tot = sum(ctx["mix_w"][k] for k in range(MIX_MAX))
    mix = _mix_eval(ctx, wi, wo) / jnp.maximum(mix_tot, 1e-8)
    pdf = jnp.where(ptype == PH_KKAY, kk, pdf)
    pdf = jnp.where(ptype == PH_MICROFLAKE, mf, pdf)
    pdf = jnp.where(ptype == PH_MIX, mix, pdf)
    return pdf


def phase_sample_ctx_v(media: MediumTable, ctx: dict, wi, u0, u1, u2):
    """Sample wo; returns (wo V3, pdf, weight = eval/pdf)."""
    from ..core import v3 as v

    if not media.has_fancy_phase:
        wo, pdf = phase_sample_v(ctx["ptype"], ctx["g"], wi, u0, u1)
        return wo, pdf, jnp.ones_like(pdf)

    ptype = ctx["ptype"]
    axis = ctx["axis"]

    # mixture: pick a component by weight, then value-proportional sampling
    mix_tot = sum(ctx["mix_w"][k] for k in range(MIX_MAX))
    cum = jnp.zeros_like(mix_tot)
    sel_t = ctx["mix_type"][0]
    sel_g = ctx["mix_g"][0]
    for k in range(MIX_MAX):
        lo = cum
        cum = cum + ctx["mix_w"][k] / jnp.maximum(mix_tot, 1e-8)
        inside = (u2 >= lo) & (u2 < jnp.minimum(cum, 1.0 - 1e-7) + 1e-7)
        sel_t = jnp.where(inside & (ctx["mix_w"][k] > 0),
                          ctx["mix_type"][k], sel_t)
        sel_g = jnp.where(inside & (ctx["mix_w"][k] > 0),
                          ctx["mix_g"][k], sel_g)
    eff_t = jnp.where(ptype == PH_MIX, sel_t, ptype)
    eff_g = jnp.where(ptype == PH_MIX, sel_g, ctx["g"])
    wo_s, _ = phase_sample_v(eff_t, eff_g, wi, u0, u1)

    # kkay: uniform sphere
    wo_kk = v.square_to_uniform_sphere(u0, u1)

    # microflake: m ~ D (Gaussian in m.axis via erfinv), wo = mirror(wi, m)
    from jax.scipy.special import erf, erfinv

    s = 1.0 / jnp.sqrt(jnp.maximum(2.0 * ctx["inv2s2"], 1e-8))
    emax = erf(1.0 / (jnp.sqrt(2.0) * jnp.maximum(s, 1e-6)))
    t = jnp.sqrt(2.0) * s * erfinv(
        jnp.clip((2.0 * u0 - 1.0) * emax, -0.999999, 0.999999))
    t = jnp.clip(t, -1.0, 1.0)
    st_m = safe_sqrt(1.0 - t * t)
    phi = 2.0 * jnp.pi * u1
    fr = v.frame_from_normal(axis)
    m = v.to_world(fr, v.V3(st_m * jnp.cos(phi), st_m * jnp.sin(phi), t))
    wo_mf = wi - m * (2.0 * wi.dot(m))

    wo = wo_s
    wo = v.where(ptype == PH_KKAY, wo_kk, wo)
    wo = v.where(ptype == PH_MICROFLAKE, wo_mf, wo)
    pdf = phase_pdf_ctx_v(media, ctx, wi, wo)
    val = phase_eval_ctx_v(media, ctx, wi, wo)
    weight = jnp.where(pdf > 1e-12, val / jnp.maximum(pdf, 1e-12), 0.0)
    # value-proportional families keep weight exactly 1 (resp. the mixture
    # weight total); guard numerical noise on those lanes
    simple = (ptype == PH_ISOTROPIC) | (ptype == PH_HG) | (
        ptype == PH_RAYLEIGH)
    weight = jnp.where(simple, 1.0, weight)
    weight = jnp.where(ptype == PH_MIX, mix_tot, weight)
    return wo, pdf, weight


# ---------------------------------------------------------------------------
# Phase functions (local frame: wi toward previous vertex, like BSDFs)
# ---------------------------------------------------------------------------

def phase_eval(ptype, g, wi, wo):
    """p(wi -> wo), normalized over the sphere."""
    cos_theta = m.dot(-wi, wo)  # angle from the propagation direction
    iso = jnp.full(cos_theta.shape, INV_FOURPI)

    # HG: forward-peaked for g > 0 (theta = 0 -> (1-g)^3 denominator)
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    hg = INV_FOURPI * (1.0 - g * g) / jnp.maximum(denom * safe_sqrt(denom), 1e-8)

    ray = (3.0 / (16.0 * jnp.pi)) * (1.0 + cos_theta * cos_theta)

    out = iso
    out = jnp.where(ptype == PH_HG, hg, out)
    out = jnp.where(ptype == PH_RAYLEIGH, ray, out)
    return out


def phase_sample(ptype, g, wi, u2):
    """Sample wo; returns (wo, pdf). HG exact inverse-CDF; isotropic uniform;
    Rayleigh exact via Cardano cubic inversion (phase/rayleigh.cpp)."""
    from ..core import warp

    # isotropic
    wo_iso = warp.square_to_uniform_sphere(u2)

    # Henyey-Greenstein
    safe_g = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u2[..., 0])
    cos_hg = (1.0 + g * g - sqr * sqr) / (2.0 * safe_g)
    cos_hg = jnp.where(jnp.abs(g) < 1e-4, 1.0 - 2.0 * u2[..., 0], cos_hg)
    cos_hg = jnp.clip(cos_hg, -1.0, 1.0)
    sin_hg = safe_sqrt(1.0 - cos_hg * cos_hg)
    phi = 2.0 * jnp.pi * u2[..., 1]
    frame = Frame.from_normal(-wi)
    wo_hg = Frame.to_world(
        frame, vec3(sin_hg * jnp.cos(phi), sin_hg * jnp.sin(phi), cos_hg)
    )

    # Rayleigh: invert u = (3x + x^3 + 4)/8 for x = cos
    z = 2.0 * (2.0 * u2[..., 0] - 1.0)
    A = jnp.cbrt(z + jnp.sqrt(z * z + 1.0))
    cos_r = jnp.clip(A - 1.0 / A, -1.0, 1.0)
    sin_r = safe_sqrt(1.0 - cos_r * cos_r)
    wo_ray = Frame.to_world(
        frame, vec3(sin_r * jnp.cos(phi), sin_r * jnp.sin(phi), cos_r)
    )

    wo = wo_iso
    wo = jnp.where((ptype == PH_HG)[..., None], wo_hg, wo)
    wo = jnp.where((ptype == PH_RAYLEIGH)[..., None], wo_ray, wo)
    pdf = phase_eval(ptype, g, wi, wo)
    return wo, pdf
