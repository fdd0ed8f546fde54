"""Spectral/color support.

The reference defaults to ``SPECTRUM_SAMPLES == 3`` (linear RGB;
``/root/reference/include/mitsuba/core/spectrum.h:25-28``) and that is the
mode this build implements: ``Spectrum`` is a ``(..., 3)`` float32 array
in linear Rec.709 RGB.  Conversions, luminance, sRGB transfer, and blackbody
spectra (reduced to RGB) provide parity with ``spectrum.cpp`` capabilities.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .types import Float

N_CHANNELS = 3


def spectrum(v) -> jax.Array:
    """Broadcast scalar or rgb triple to a spectrum array."""
    a = jnp.asarray(v, Float)
    if a.ndim == 0:
        a = jnp.broadcast_to(a, (3,))
    return a


def luminance(rgb: jax.Array) -> jax.Array:
    """ITU-R Rec. BT.709 luminance (reference spectrum.h getLuminance)."""
    return (
        rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169
    )


# Matrices from reference src/libcore/spectrum.cpp (ITU-R Rec. BT.709 D65).
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)


def rgb_to_xyz(rgb: jax.Array) -> jax.Array:
    return jnp.matmul(rgb, jnp.asarray(_RGB2XYZ.T, Float),
                      precision=jax.lax.Precision.HIGHEST)


def xyz_to_rgb(xyz: jax.Array) -> jax.Array:
    return jnp.matmul(xyz, jnp.asarray(_XYZ2RGB.T, Float),
                      precision=jax.lax.Precision.HIGHEST)


def srgb_to_linear(c):
    c = jnp.asarray(c, Float)
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = jnp.asarray(c, Float)
    c = jnp.maximum(c, 0.0)
    return jnp.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def blackbody_rgb(temperature_k: float) -> np.ndarray:
    """Planck emitter reduced to linear RGB (W/(m^2*sr)-scaled), host-side.

    Capability analog of ``BlackBodySpectrum`` (spectrum.h); integrates
    Planck's law against CIE curves coarsely (5nm steps, 360..830nm).
    """
    lam = np.arange(360.0, 831.0, 5.0) * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    I = (2 * h * c * c) / (lam ** 5 * (np.exp(h * c / (lam * kb * temperature_k)) - 1.0))
    I *= 1e-9  # per nm
    x, y, z = _cie_xyz(lam * 1e9)
    X = np.trapezoid(I * x, lam * 1e9)
    Y = np.trapezoid(I * y, lam * 1e9)
    Z = np.trapezoid(I * z, lam * 1e9)
    rgb = _XYZ2RGB @ np.array([X, Y, Z])
    return np.maximum(rgb, 0.0)


def interpolated_rgb(wavelengths_nm, values) -> np.ndarray:
    """Piecewise-linear SPD -> linear RGB, host-side.

    Capability analog of ``InterpolatedSpectrum`` + ``Spectrum::toXYZ``
    (reference ``src/libcore/spectrum.cpp``): the SPD is linearly
    interpolated between samples (zero outside its support, as in the
    reference), integrated against the CIE 1931 observer, normalized so a
    flat unit SPD maps to Y=1 (reflectance convention), and converted to
    Rec.709 RGB.
    """
    wl = np.asarray(wavelengths_nm, np.float64)
    sv = np.asarray(values, np.float64)
    if wl.size < 2:
        # reference InterpolatedSpectrum::eval returns 0 for <2 samples
        # (spectrum.cpp size guard); np.interp would instead return the
        # single value at exact grid matches / raise on empty input
        return np.zeros(3)
    order = np.argsort(wl)
    wl, sv = wl[order], sv[order]
    lam = np.arange(360.0, 831.0, 1.0)
    spd = np.interp(lam, wl, sv, left=0.0, right=0.0)
    x, y, z = _cie_xyz(lam)
    norm = np.trapezoid(y, lam)
    X = np.trapezoid(spd * x, lam) / norm
    Y = np.trapezoid(spd * y, lam) / norm
    Z = np.trapezoid(spd * z, lam) / norm
    return _XYZ2RGB @ np.array([X, Y, Z])


def _cie_xyz(lam_nm: np.ndarray):
    """Analytic multi-lobe Gaussian fits to CIE 1931 (Wyman et al. 2013)."""

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    x = (
        1.056 * g(lam_nm, 599.8, 37.9, 31.0)
        + 0.362 * g(lam_nm, 442.0, 16.0, 26.7)
        - 0.065 * g(lam_nm, 501.1, 20.4, 26.2)
    )
    y = 0.821 * g(lam_nm, 568.8, 46.9, 40.5) + 0.286 * g(lam_nm, 530.9, 16.3, 31.1)
    z = 1.217 * g(lam_nm, 437.0, 11.8, 36.0) + 0.681 * g(lam_nm, 459.0, 26.0, 13.8)
    return x, y, z
