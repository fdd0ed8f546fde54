"""Rough dielectric transmittance tables.

Parity target: ``/root/reference/src/bsdfs/rtrans.h`` + the ``rdielprec``
utility (``/root/reference/src/utils/rdielprec.cpp``) — the reference ships
precomputed tables of the directional transmittance through a rough
dielectric microfacet boundary,

    T(cos_theta_i; alpha, eta) = Int f_t(wi, wo) dwo,

and its hemispherical (diffuse) average; ``roughplastic.cpp:373-382`` and
``roughcoating.cpp`` interpolate them for energy-conserving diffuse terms
and for specular/diffuse lobe-selection probabilities.

Wavefront design: instead of the reference's cubic-interpolated spline file
(``data/microfacet/*.dat``), a small dense grid — (2 dists, 2 eta blocks,
NE etas, NA alphas, NT angles) — generated here by vectorized numpy QMC
integration (visible-normal / NDF importance sampling, Walter 2007 weights),
cached to ``data/rtrans.npz`` inside the package, and evaluated in-kernel by
trilinear interpolation with flat gathers (8 taps per lane, only on the
roughplastic/roughcoating branch).

Axis warps (chosen so the smooth limit is exact at the grid edge):
  eta:   w = ((eta' - 1) / (ETA_MAX - 1))**0.25, eta' = max(eta, 1/eta);
         block 0 = entering denser (eta > 1), block 1 = leaving (eta < 1)
  alpha: w = sqrt(alpha / ALPHA_MAX)  (knot 0 is alpha ~ 0 = smooth Fresnel)
  theta: w = cos_theta (linear)
"""
from __future__ import annotations

import os

import numpy as np

from .microfacet import DIST_BECKMANN, DIST_GGX, DIST_PHONG

NE, NA, NT = 16, 16, 32
ETA_MAX = 4.0
ALPHA_MAX = 1.0
_M = 2048  # QMC samples per table entry

_DATA_PATH = os.path.join(os.path.dirname(__file__), "..", "data",
                          "rtrans.npz")


# ---------------------------------------------------------------------------
# numpy generation (the rdielprec analog)
# ---------------------------------------------------------------------------

def _fresnel_np(c, eta):
    """Dielectric Fresnel reflectance for cos_theta_i = c (>0), relative
    ior eta (either side); returns (F, cos_theta_t)."""
    st2_t = (1.0 - c * c) / (eta * eta)
    tir = st2_t >= 1.0
    ct_t = np.sqrt(np.maximum(1.0 - st2_t, 0.0))
    rs = (c - eta * ct_t) / np.maximum(c + eta * ct_t, 1e-12)
    rp = (eta * c - ct_t) / np.maximum(eta * c + ct_t, 1e-12)
    F = 0.5 * (rs * rs + rp * rp)
    return np.where(tir, 1.0, F), ct_t


def _g1_np(dist, w_z, w_dot_m, alpha):
    """Smith masking (isotropic), matching microfacet.smith_g1_v."""
    chi = (w_dot_m * w_z) > 0
    ct2 = np.minimum(w_z * w_z, 1.0)
    tan2 = np.maximum(1.0 - ct2, 0.0) / np.maximum(ct2, 1e-12)
    if dist == DIST_GGX:
        g = 2.0 / (1.0 + np.sqrt(1.0 + alpha * alpha * tan2))
    else:
        a = 1.0 / np.maximum(alpha * np.sqrt(np.maximum(tan2, 0.0)), 1e-12)
        g = np.where(a >= 1.6, 1.0,
                     (3.535 * a + 2.181 * a * a)
                     / (1.0 + 2.276 * a + 2.577 * a * a))
    g = np.where(tan2 <= 1e-16, 1.0, g)
    return np.where(chi, g, 0.0)


def _sample_m_np(dist, wi, alpha, u1, u2):
    """Sample a microfacet normal for incident wi = (st, 0, ct).

    GGX: Heitz VNDF (weight excludes G1(wi)); Beckmann: full-NDF
    (Walter 2007).  Returns (m, kind) where kind says which weight rule
    applies."""
    if dist == DIST_GGX:
        st, ct = wi
        vx, vy, vz = np.broadcast_arrays(alpha * st + 0 * u1,
                                         np.zeros_like(u1), ct + 0 * u1)
        vh = np.stack([vx, vy, vz], -1)
        vh = vh / np.linalg.norm(vh, axis=-1, keepdims=True)
        lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
        inv_len = 1.0 / np.sqrt(np.maximum(lensq, 1e-14))
        good = lensq > 1e-14
        t1 = np.stack([np.where(good, -vh[..., 1] * inv_len, 1.0),
                       np.where(good, vh[..., 0] * inv_len, 0.0),
                       np.zeros_like(lensq)], -1)
        t2 = np.cross(vh, t1)
        r = np.sqrt(u1)
        phi = 2 * np.pi * u2
        p1 = r * np.cos(phi)
        p2 = r * np.sin(phi)
        s = 0.5 * (1.0 + vh[..., 2])
        p2 = (1 - s) * np.sqrt(np.maximum(1 - p1 * p1, 0)) + s * p2
        pz = np.sqrt(np.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
        nh = (t1 * p1[..., None] + t2 * p2[..., None] + vh * pz[..., None])
        m = np.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                      np.maximum(nh[..., 2], 1e-6)], -1)
        return m / np.linalg.norm(m, axis=-1, keepdims=True)
    else:  # beckmann full-NDF
        tan2 = -alpha * alpha * np.log(np.maximum(1.0 - u1, 1e-20))
        ct_m = 1.0 / np.sqrt(1.0 + tan2)
        st_m = np.sqrt(np.maximum(1.0 - ct_m * ct_m, 0.0))
        phi = 2 * np.pi * u2
        return np.stack([st_m * np.cos(phi), st_m * np.sin(phi), ct_m], -1)


def _trans_albedo_np(dist, ct_i, alpha, eta, u1, u2):
    """MC estimate of the transmitted energy fraction for incidence angle
    acos(ct_i); (ct_i, u1, u2) broadcast together."""
    st_i = np.sqrt(np.maximum(1.0 - ct_i * ct_i, 0.0))
    m = _sample_m_np(dist, (st_i, ct_i), alpha, u1, u2)
    c = st_i * m[..., 0] + ct_i * m[..., 2]  # wi . m
    F, ct_t = _fresnel_np(np.maximum(c, 0.0), eta)
    # refracted direction: wo = -wi/eta + (c/eta - ct_t) m
    inv_eta = 1.0 / eta
    k = c * inv_eta - ct_t
    wo_z = -ct_i * inv_eta + k * m[..., 2]
    wo_x = -st_i * inv_eta + k * m[..., 0]
    wo_y = k * m[..., 1]
    wo_dot_m = wo_x * m[..., 0] + wo_y * m[..., 1] + wo_z * m[..., 2]
    ok = (c > 1e-8) & (wo_z < -1e-8)
    g_wo = _g1_np(dist, wo_z, wo_dot_m, alpha)
    if dist == DIST_GGX:
        # VNDF sampling: weight = (1-F) * G2 / G1(wi) = (1-F) * G1(wo)
        w = (1.0 - F) * g_wo
    else:
        # NDF sampling (pdf = D m.z): Walter07 eq.41 weight
        g_wi = _g1_np(dist, ct_i, c, alpha)
        w = ((1.0 - F) * g_wi * g_wo * np.abs(c)
             / np.maximum(ct_i * m[..., 2], 1e-8))
    return np.where(ok, w, 0.0).mean(-1)


def eta_knots() -> np.ndarray:
    w = np.arange(NE) / (NE - 1)
    return 1.0 + (ETA_MAX - 1.0) * w ** 4 + 1e-4


def alpha_knots() -> np.ndarray:
    w = np.arange(NA) / (NA - 1)
    return np.maximum(ALPHA_MAX * w * w, 1e-5)


def ct_knots() -> np.ndarray:
    return np.maximum(np.arange(NT) / (NT - 1), 5e-3)


def generate_tables(m_samples: int = _M, verbose: bool = False):
    """Regenerate the transmittance grid (the ``rdielprec`` entry point).

    Returns (trans, diff): (2, 2, NE, NA, NT) directional and (2, 2, NE, NA)
    cosine-weighted hemispherical transmittance; axis 0 = dist
    (0 beckmann, 1 ggx), axis 1 = eta block (0: eta>1, 1: eta<1)."""
    # Hammersley points (deterministic QMC)
    i = np.arange(m_samples, dtype=np.float64)
    u1 = (i + 0.5) / m_samples
    rev = np.zeros(m_samples)
    denom, ii = 2.0, i.astype(np.int64)
    while ii.max() > 0:
        rev += (ii & 1) / denom
        ii >>= 1
        denom *= 2
    u2 = rev

    etas, alphas, cts = eta_knots(), alpha_knots(), ct_knots()
    trans = np.zeros((2, 2, NE, NA, NT), np.float32)
    diff = np.zeros((2, 2, NE, NA), np.float32)
    ct_g = cts[:, None]  # (NT, 1) broadcast with (M,)
    for d_idx, dist in enumerate((DIST_BECKMANN, DIST_GGX)):
        for blk in range(2):
            for ie, eta in enumerate(etas):
                e = eta if blk == 0 else 1.0 / eta
                for ia, a in enumerate(alphas):
                    t = _trans_albedo_np(dist, ct_g, a, e, u1[None], u2[None])
                    trans[d_idx, blk, ie, ia] = t
                    # diffuse: 2 * int T(ct) ct dct over the warped knots
                    diff[d_idx, blk, ie, ia] = 2.0 * np.trapezoid(
                        t * cts, cts)
                if verbose:
                    print(f"[rtrans] dist={d_idx} blk={blk} "
                          f"eta={eta:.3f} done")
    return np.clip(trans, 0, 1), np.clip(diff, 0, 1)


def save_tables(path: str | None = None, **kw) -> str:
    path = path or os.path.abspath(_DATA_PATH)
    trans, diff = generate_tables(**kw)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, trans=trans, diff=diff)
    return path


_CACHE = None


def load_tables():
    """(trans, diff) numpy arrays, generated on first use and cached."""
    global _CACHE
    if _CACHE is None:
        path = os.path.abspath(_DATA_PATH)
        if not os.path.exists(path):
            save_tables(path)
        with np.load(path) as z:
            _CACHE = (np.asarray(z["trans"], np.float32),
                      np.asarray(z["diff"], np.float32))
    return _CACHE


# ---------------------------------------------------------------------------
# in-kernel evaluation (jax)
# ---------------------------------------------------------------------------

def _grid_coords(eta_s, alpha, ct):
    import jax.numpy as jnp

    blk = (eta_s < 1.0).astype(jnp.int32)
    e = jnp.maximum(eta_s, 1.0 / jnp.maximum(eta_s, 1e-6))
    fe = ((jnp.clip(e, 1.0, ETA_MAX) - 1.0) / (ETA_MAX - 1.0)) ** 0.25 \
        * (NE - 1)
    fa = jnp.sqrt(jnp.clip(alpha, 0.0, ALPHA_MAX) / ALPHA_MAX) * (NA - 1)
    ft = jnp.clip(ct, 0.0, 1.0) * (NT - 1)
    return blk, fe, fa, ft


def rtrans_eval_v(dist, ct, alpha, eta_s):
    """Directional rough transmittance T(ct; alpha, eta), per lane.

    ``dist`` is the per-lane microfacet distribution code (phong uses the
    beckmann table, as does the reference's equivalent-exponent mapping)."""
    import jax.numpy as jnp

    trans, _ = load_tables()
    tab = jnp.asarray(trans.reshape(-1))  # (2*2*NE*NA*NT,)
    d = (dist == DIST_GGX).astype(jnp.int32)
    blk, fe, fa, ft = _grid_coords(eta_s, alpha, ct)
    ie = jnp.clip(jnp.floor(fe).astype(jnp.int32), 0, NE - 2)
    ia = jnp.clip(jnp.floor(fa).astype(jnp.int32), 0, NA - 2)
    it = jnp.clip(jnp.floor(ft).astype(jnp.int32), 0, NT - 2)
    we, wa, wt = fe - ie, fa - ia, ft - it
    base = ((d * 2 + blk) * NE + ie) * NA * NT + ia * NT + it

    def tap(de, da, dt):
        return tab[base + de * (NA * NT) + da * NT + dt]

    t00 = tap(0, 0, 0) * (1 - wt) + tap(0, 0, 1) * wt
    t01 = tap(0, 1, 0) * (1 - wt) + tap(0, 1, 1) * wt
    t10 = tap(1, 0, 0) * (1 - wt) + tap(1, 0, 1) * wt
    t11 = tap(1, 1, 0) * (1 - wt) + tap(1, 1, 1) * wt
    t0 = t00 * (1 - wa) + t01 * wa
    t1 = t10 * (1 - wa) + t11 * wa
    return jnp.clip(t0 * (1 - we) + t1 * we, 0.0, 1.0)


def rtrans_diffuse_v(dist, alpha, eta_s):
    """Hemispherical (cosine-weighted) rough transmittance, per lane."""
    import jax.numpy as jnp

    _, diff = load_tables()
    tab = jnp.asarray(diff.reshape(-1))  # (2*2*NE*NA,)
    d = (dist == DIST_GGX).astype(jnp.int32)
    blk, fe, fa, _ = _grid_coords(eta_s, alpha, jnp.zeros_like(alpha))
    ie = jnp.clip(jnp.floor(fe).astype(jnp.int32), 0, NE - 2)
    ia = jnp.clip(jnp.floor(fa).astype(jnp.int32), 0, NA - 2)
    we, wa = fe - ie, fa - ia
    base = ((d * 2 + blk) * NE + ie) * NA + ia

    def tap(de, da):
        return tab[base + de * NA + da]

    t0 = tap(0, 0) * (1 - wa) + tap(0, 1) * wa
    t1 = tap(1, 0) * (1 - wa) + tap(1, 1) * wa
    return jnp.clip(t0 * (1 - we) + t1 * we, 0.0, 1.0)
