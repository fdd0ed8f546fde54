"""BSDF evaluate / pdf / sample with static type dispatch.

Conventions follow the reference (``include/mitsuba/render/bsdf.h``): all
directions live in the local shading frame (+z = shading normal), ``wi``
points toward the camera/previous vertex, ``eval`` returns f * |cos_theta_o|
for the *smooth* components only, and ``sample`` returns the importance
weight f*cos/pdf.  Delta components return eval = pdf = 0 so NEE and MIS
compose exactly like the reference path tracer (``path.cpp:119-290``).

Each lobe family cites its reference plugin in the function docstring.

Canonical implementations are component-SoA (:class:`LaneParams3` with V3
spectra, V3 directions) — every op is then a flat elementwise op with no
reduce over a trailing axis of 3.  The ``(..., 3)``-array API at the
bottom wraps them for not-yet-migrated callers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import v3 as v
from ..core.v3 import V3, safe_div
from .common import (
    LaneParams, LaneParams3, lane_params_to_v,
    DIFFUSE, ROUGHDIFFUSE, CONDUCTOR, ROUGHCONDUCTOR, DIELECTRIC,
    THINDIELECTRIC, ROUGHDIELECTRIC, PLASTIC, ROUGHPLASTIC, PHONG, WARD,
    NULL_BSDF, DIFFTRANS, HK, IRAWAN, COATING, FLAG_TWOSIDED,
)
from .fresnel import (
    fresnel_dielectric, fresnel_conductor_v, fresnel_diffuse_reflectance,
)
from . import microfacet as mf

INV_PI = 1.0 / jnp.pi


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


class BSDFSample3(NamedTuple):
    wo: V3
    weight: V3  # f*cos/pdf (includes discrete lobe probs)
    pdf: jax.Array  # solid-angle pdf of smooth lobes (delta: 1.0)
    delta: jax.Array  # bool — sampled a delta component
    eta: jax.Array  # relative-IOR change along the sampled lobe
    null_passthrough: jax.Array  # bool — mask/null straight-through


class BSDFSample(NamedTuple):
    wo: jax.Array  # (..., 3)
    weight: jax.Array  # (..., 3)
    pdf: jax.Array
    delta: jax.Array
    eta: jax.Array
    null_passthrough: jax.Array


def _m3(ok, val: V3) -> V3:
    """val where ok else 0 (per-component)."""
    return V3(jnp.where(ok, val.x, 0.0), jnp.where(ok, val.y, 0.0),
              jnp.where(ok, val.z, 0.0))


def _maybe_flip(p, wi: V3, wo: V3 | None = None):
    """Twosided wrapper: mirror the frame for back-facing lanes."""
    flip = ((p.flags & FLAG_TWOSIDED) != 0) & (wi.z < 0)
    fz = jnp.where(flip, -1.0, 1.0)
    wi2 = V3(wi.x, wi.y, wi.z * fz)
    if wo is None:
        return wi2, flip
    return wi2, V3(wo.x, wo.y, wo.z * fz), flip


# ---------------------------------------------------------------------------
# Smooth-component eval / pdf per type
# ---------------------------------------------------------------------------

def _eval_diffuse(p, wi, wo):
    """src/bsdfs/diffuse.cpp"""
    ok = (wi.z > 0) & (wo.z > 0)
    val = p.refl * (INV_PI * jnp.maximum(wo.z, 0.0))
    return _m3(ok, val)


def _pdf_diffuse(p, wi, wo):
    ok = (wi.z > 0) & (wo.z > 0)
    return jnp.where(ok, v.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _eval_roughdiffuse(p, wi, wo):
    """Oren-Nayar (src/bsdfs/roughdiffuse.cpp, full model).  sigma is the
    Beckmann-style alpha converted with the reference's 1/sqrt(2) factor."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    sigma = p.alpha_u * 0.70711
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    i_lt_o = ci < co
    sin_a = jnp.where(i_lt_o, v.sin_theta(wi), v.sin_theta(wo))
    tan_b = jnp.where(i_lt_o, v.tan_theta(wo), v.tan_theta(wi))
    cpd = v.cos_phi(wi) * v.cos_phi(wo) + v.sin_phi(wi) * v.sin_phi(wo)
    val = p.refl * (
        INV_PI * co * (A + B * jnp.maximum(cpd, 0.0) * sin_a * tan_b)
    )
    return _m3(ok, val)


def _eval_roughconductor(p, wi, wo):
    """src/bsdfs/roughconductor.cpp: D*G*F/(4 cos_i) (already x cos_o)."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = (wi + wo).normalized()
    D = mf.ndf_v(p.dist, h, p.alpha_u, p.alpha_v)
    G = mf.smith_g2_v(p.dist, wi, wo, h, p.alpha_u, p.alpha_v)
    F = fresnel_conductor_v(wi.dot(h), p.eta, p.k)
    val = p.spec * F * (D * G / jnp.maximum(4.0 * ci, 1e-8))
    return _m3(ok & (D > 0), val)


def _pdf_roughconductor(p, wi, wo):
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = (wi + wo).normalized()
    pm = mf.pdf_visible_v(p.dist, wi, h, p.alpha_u, p.alpha_v)
    return jnp.where(ok, pm / jnp.maximum(4.0 * jnp.abs(wo.dot(h)), 1e-8), 0.0)


def _rough_dielectric_halfvec(p, wi, wo):
    ci = wi.z
    reflecting = ci * wo.z > 0
    eta_i = jnp.where(ci > 0, 1.0, p.eta_s)
    eta_o = jnp.where(ci > 0, p.eta_s, 1.0)
    h_r = wi + wo
    h_t = -(wi * eta_i + wo * eta_o)
    h = v.where(reflecting, h_r, h_t).normalized()
    h = h * jnp.where(h.z < 0, -1.0, 1.0)
    return h, reflecting, eta_i, eta_o


def _eval_roughdielectric(p, wi, wo):
    """src/bsdfs/roughdielectric.cpp (Walter et al. 2007), radiance mode."""
    ci, co = wi.z, wo.z
    h, reflecting, eta_i, eta_o = _rough_dielectric_halfvec(p, wi, wo)
    D = mf.ndf_v(p.dist, h, p.alpha_u, p.alpha_v)
    G = mf.smith_g2_v(p.dist, wi, wo, h, p.alpha_u, p.alpha_v)
    F, _, _, _ = fresnel_dielectric(wi.dot(h), p.eta_s)

    # reflection branch
    val_r = p.spec * (F * D * G / jnp.maximum(4.0 * jnp.abs(ci), 1e-8))

    # transmission branch
    wih = wi.dot(h)
    woh = wo.dot(h)
    sqrt_denom = eta_i * wih + eta_o * woh
    # radiance solid-angle compression: (1/eta_crossing)^2
    eta_rel = eta_o / eta_i
    factor = (1.0 / eta_rel) ** 2
    val_t_scalar = (
        jnp.abs(wih * woh / jnp.maximum(jnp.abs(ci * co), 1e-8))
        * (eta_o * eta_o * (1.0 - F) * D * G)
        / jnp.maximum(sqrt_denom * sqrt_denom, 1e-12)
        * factor
        * jnp.abs(co)
    )
    val_t = p.trans * val_t_scalar

    valid = (D > 0) & (jnp.abs(ci) > 1e-7)
    out = v.where(reflecting, val_r, val_t)
    return _m3(valid, out)


def _pdf_roughdielectric(p, wi, wo):
    h, reflecting, eta_i, eta_o = _rough_dielectric_halfvec(p, wi, wo)
    wi_up = v.where(wi.z < 0, -wi, wi)
    pm = mf.pdf_visible_v(p.dist, wi_up, h, p.alpha_u, p.alpha_v)
    F, _, _, _ = fresnel_dielectric(wi.dot(h), p.eta_s)
    prob = jnp.where(reflecting, F, 1.0 - F)
    woh = wo.dot(h)
    wih = wi.dot(h)
    # route validity (the sampler rejects side-violating lobes, matching the
    # reference roughdielectric.cpp): reflection needs wi, wo on the same
    # side of h; transmission on opposite sides.
    valid = jnp.where(reflecting, wih * woh > 0, wih * woh < 0)
    sqrt_denom = eta_i * wih + eta_o * woh
    jac_r = 1.0 / jnp.maximum(4.0 * jnp.abs(woh), 1e-8)
    jac_t = (eta_o * eta_o * jnp.abs(woh)) / jnp.maximum(
        sqrt_denom * sqrt_denom, 1e-12)
    jac = jnp.where(reflecting, jac_r, jac_t)
    return jnp.where(valid, jnp.maximum(pm * prob * jac, 0.0), 0.0)


def _plastic_terms(p, wi, wo):
    """src/bsdfs/plastic.cpp diffuse term + sampling weights."""
    ci, co = wi.z, wo.z
    Fi, _, _, _ = fresnel_dielectric(ci, p.eta_s)
    Fo, _, _, _ = fresnel_dielectric(co, p.eta_s)
    fdr_int = fresnel_diffuse_reflectance(1.0 / p.eta_s)
    inv_eta2 = 1.0 / (p.eta_s * p.eta_s)
    # nonlinear=False default: scalar fdr correction
    diff = p.refl * (1.0 / jnp.maximum(1.0 - fdr_int, 1e-6))
    val = diff * (INV_PI * jnp.maximum(co, 0.0) * inv_eta2
                  * (1.0 - Fi) * (1.0 - Fo))
    return val, Fi


def _spec_sampling_weight(p):
    s = p.spec.mean()
    d = p.refl.mean()
    return s / jnp.maximum(s + d, 1e-8)


def _prob_specular(p, Fi):
    sw = _spec_sampling_weight(p)
    ps = Fi * sw
    pd = (1.0 - Fi) * (1.0 - sw)
    return ps / jnp.maximum(ps + pd, 1e-8)


def _coat_cos_inside(c, eta):
    """Refracted cosine inside the coat: sin' = sin/eta."""
    return safe_sqrt(1.0 - (1.0 - c * c) / (eta * eta))


def _eval_coating(p, wi, wo):
    """Smooth dielectric coating over a diffuse substrate
    (``src/bsdfs/coating.cpp:37-39,161-170``): both directions refract into
    the coat, the substrate evaluates in the refracted frame, Beer
    absorption ``exp(-sigmaA*d*(1/cos_i' + 1/cos_o'))`` attenuates both
    crossings, and the solid-angle compression contributes 1/eta^2 (the
    refracted substrate cosine cancels against the measure change)."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    eta = p.eta_s
    F_i, _, _, _ = fresnel_dielectric(ci, eta)
    F_o, _, _, _ = fresnel_dielectric(co, eta)
    ci_p = jnp.maximum(_coat_cos_inside(ci, eta), 1e-6)
    co_p = jnp.maximum(_coat_cos_inside(co, eta), 1e-6)
    absorption = (p.trans * (-(1.0 / ci_p + 1.0 / co_p))).exp()
    scale = (INV_PI * jnp.maximum(co, 0.0) * (1.0 - F_i) * (1.0 - F_o)
             / (eta * eta))
    return _m3(ok, p.refl * absorption * scale)


def _pdf_coating(p, wi, wo):
    """Substrate lobe pdf: cosine sampling inside the coat pushed through
    the exit refraction (d_omega'/d_omega = cos/(eta^2 cos')), times the
    non-specular lobe probability 1 - F(wi)."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    F_i, _, _, _ = fresnel_dielectric(ci, p.eta_s)
    return jnp.where(ok, (1.0 - F_i) * jnp.maximum(co, 0.0)
                     * INV_PI / (p.eta_s * p.eta_s), 0.0)


def _eval_plastic(p, wi, wo):
    ok = (wi.z > 0) & (wo.z > 0)
    val, _ = _plastic_terms(p, wi, wo)
    return _m3(ok, val)


def _pdf_plastic(p, wi, wo):
    ok = (wi.z > 0) & (wo.z > 0)
    Fi, _, _, _ = fresnel_dielectric(wi.z, p.eta_s)
    prob_spec = _prob_specular(p, Fi)
    return jnp.where(
        ok, v.square_to_cosine_hemisphere_pdf(wo) * (1.0 - prob_spec), 0.0)


def _prob_specular_rough(p, ci):
    """Lobe-selection probability for roughplastic: 1 - T_ext(ct), mixed
    with the reflectance-based sampling weight (roughplastic.cpp:414-421)."""
    from .rtrans import rtrans_eval_v

    alpha = 0.5 * (p.alpha_u + p.alpha_v)
    ps = 1.0 - rtrans_eval_v(p.dist, jnp.maximum(ci, 0.0), alpha, p.eta_s)
    sw = _spec_sampling_weight(p)
    num = ps * sw
    return num / jnp.maximum(num + (1.0 - ps) * (1.0 - sw), 1e-8)


def _eval_roughplastic(p, wi, wo):
    """src/bsdfs/roughplastic.cpp: GGX/Beckmann specular lobe + diffuse term
    attenuated by precomputed rough transmittance tables
    (roughplastic.cpp:373-382; tables = bsdf/rtrans.py, the rtrans.h
    analog) with internal-scattering Fdr correction."""
    from .rtrans import rtrans_eval_v, rtrans_diffuse_v

    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = (wi + wo).normalized()
    D = mf.ndf_v(p.dist, h, p.alpha_u, p.alpha_v)
    G = mf.smith_g2_v(p.dist, wi, wo, h, p.alpha_u, p.alpha_v)
    F, _, _, _ = fresnel_dielectric(wi.dot(h), p.eta_s)
    spec = p.spec * (F * D * G / jnp.maximum(4.0 * ci, 1e-8))
    alpha = 0.5 * (p.alpha_u + p.alpha_v)
    T12 = rtrans_eval_v(p.dist, jnp.maximum(ci, 0.0), alpha, p.eta_s)
    T21 = rtrans_eval_v(p.dist, jnp.maximum(co, 0.0), alpha, p.eta_s)
    fdr = 1.0 - rtrans_diffuse_v(p.dist, alpha,
                                 1.0 / jnp.maximum(p.eta_s, 1e-6))
    inv_eta2 = 1.0 / (p.eta_s * p.eta_s)
    diff = (p.refl * (1.0 / jnp.maximum(1.0 - fdr, 1e-6))
            * (INV_PI * jnp.maximum(co, 0.0) * inv_eta2 * T12 * T21))
    return _m3(ok, spec + diff)


def _pdf_roughplastic(p, wi, wo):
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = (wi + wo).normalized()
    prob_spec = _prob_specular_rough(p, ci)
    pm = mf.pdf_visible_v(p.dist, wi, h, p.alpha_u, p.alpha_v)
    pdf_s = pm / jnp.maximum(4.0 * jnp.abs(wo.dot(h)), 1e-8)
    pdf_d = v.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(ok, prob_spec * pdf_s + (1.0 - prob_spec) * pdf_d, 0.0)


def _eval_phong(p, wi, wo):
    """src/bsdfs/phong.cpp: modified Phong = diffuse + (n+2)/2pi cos^n."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    alpha = wo.dot(v.reflect(wi))
    n = p.exponent
    spec = p.spec * (
        jnp.where(alpha > 0, jnp.power(jnp.maximum(alpha, 1e-12), n), 0.0)
        * (n + 2.0) * (0.5 * INV_PI) * co
    )
    diff = p.refl * (INV_PI * co)
    return _m3(ok, spec + diff)


def _pdf_phong(p, wi, wo):
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    sw = _spec_sampling_weight(p)
    alpha = jnp.maximum(wo.dot(v.reflect(wi)), 0.0)
    n = p.exponent
    pdf_s = jnp.power(jnp.maximum(alpha, 1e-12), n) * (n + 1.0) * (0.5 * INV_PI)
    pdf_s = jnp.where(alpha > 0, pdf_s, 0.0)
    pdf_d = v.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(ok, sw * pdf_s + (1.0 - sw) * pdf_d, 0.0)


def _eval_ward(p, wi, wo):
    """src/bsdfs/ward.cpp (balanced variant)."""
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    h = wi + wo
    au, av = p.alpha_u, p.alpha_v
    exp_arg = -(
        (h.x / au) ** 2 + (h.y / av) ** 2
    ) / jnp.maximum(h.z ** 2, 1e-12)
    spec_scalar = jnp.exp(exp_arg) / (
        4.0 * jnp.pi * au * av * jnp.maximum(jnp.sqrt(ci * co), 1e-8)
    )
    spec = p.spec * (spec_scalar * co)
    diff = p.refl * (INV_PI * co)
    return _m3(ok, spec + diff)


def _pdf_ward(p, wi, wo):
    ci, co = wi.z, wo.z
    ok = (ci > 0) & (co > 0)
    sw = _spec_sampling_weight(p)
    h = (wi + wo).normalized()
    au, av = p.alpha_u, p.alpha_v
    exp_arg = -v.tan_theta2(h) * (
        v.cos_phi(h) ** 2 / (au * au) + v.sin_phi(h) ** 2 / (av * av)
    )
    pdf_h = jnp.exp(exp_arg) / (
        jnp.pi * au * av * jnp.maximum(h.z ** 3, 1e-8)
    )
    pdf_s = pdf_h / jnp.maximum(4.0 * jnp.abs(wo.dot(h)), 1e-8)
    pdf_d = v.square_to_cosine_hemisphere_pdf(wo)
    return jnp.where(ok, sw * pdf_s + (1.0 - sw) * pdf_d, 0.0)


def _eval_difftrans(p, wi, wo):
    """src/bsdfs/difftrans.cpp"""
    opposite = wi.z * wo.z < 0
    val = p.trans * (INV_PI * jnp.abs(wo.z))
    return _m3(opposite, val)


def _pdf_difftrans(p, wi, wo):
    opposite = wi.z * wo.z < 0
    return jnp.where(opposite, jnp.abs(wo.z) * INV_PI, 0.0)


def _hg_phase(g, cos_t):
    denom = 1.0 + g * g - 2.0 * g * cos_t
    return (0.25 * INV_PI) * (1.0 - g * g) / jnp.maximum(
        denom * safe_sqrt(denom), 1e-8)


def _hk_pdelta(p, ci):
    """Probability of the attenuated straight-through delta lobe."""
    att = (p.trans * (-1.0 / jnp.maximum(ci, 1e-4))).exp()
    return jnp.clip(att.mean(), 0.0, 0.95)


def _eval_hk(p, wi, wo):
    """src/bsdfs/hk.cpp (Hanrahan-Krueger 1993): single scattering in a slab
    of optical depth tau (p.trans) with single-scattering albedo (p.refl) and
    HG phase (g = p.alpha_u).  Smooth reflection + transmission terms; the
    attenuated delta transmission is handled in sampling only."""
    ci = jnp.maximum(jnp.abs(wi.z), 1e-4)
    co = jnp.maximum(jnp.abs(wo.z), 1e-4)
    same = wi.z * wo.z > 0
    tau = p.trans
    ph = _hg_phase(p.alpha_u, -wi.dot(wo))

    # reflection: alpha*p/(ci+co) * (1 - e^{-tau(1/ci+1/co)})
    one_m = 1.0 - (tau * (-(1.0 / ci + 1.0 / co))).exp()
    fr = p.refl * ph * one_m * (1.0 / (ci + co))

    # transmission: alpha*p*(e^{-tau/ci} - e^{-tau/co})/(ci - co), with the
    # ci -> co limit alpha*p*tau/ci^2 e^{-tau/ci}
    dm = ci - co
    e_ci = (tau * (-1.0 / ci)).exp()
    e_co = (tau * (-1.0 / co)).exp()
    small_dm = jnp.abs(dm) < 1e-5
    ft_reg = (e_ci - e_co) * (1.0 / jnp.where(small_dm, 1.0, dm))
    ft_lim = tau * (1.0 / (ci * ci)) * e_ci
    ft = p.refl * ph * v.where(small_dm, ft_lim, ft_reg)

    out = v.where(same, fr, ft) * co
    return out.maximum(0.0)


def _pdf_hk(p, wi, wo):
    ci = jnp.abs(wi.z)
    pd = _hk_pdelta(p, ci)
    return (1.0 - pd) * 0.5 * jnp.abs(wo.z) * INV_PI


def _eval_irawan(p: LaneParams3, wi: V3, wo: V3) -> V3:
    """Irawan & Marschner woven cloth (src/bsdfs/irawan.cpp eval): weave
    patterns are static aux data; each pattern present in the scene gets
    its own fused branch, selected per lane by weave_id."""
    from . import irawan as ir

    out = v.zeros(p.eta_s.shape)
    if not p.weaves:
        return out
    for widx, pat in enumerate(p.weaves):
        val = ir.eval_pattern(pat, p.uv_u, p.uv_v, wi, wo)
        out = v.where(p.weave_id == widx, val, out)
    return out


def _pdf_irawan(p: LaneParams3, wi: V3, wo: V3) -> jax.Array:
    """Cosine-hemisphere sampling (irawan.cpp pdf())."""
    return jnp.where((wi.z > 0.0) & (wo.z > 0.0),
                     jnp.abs(wo.z) * INV_PI, 0.0)


_EVAL = {
    DIFFUSE: (_eval_diffuse, _pdf_diffuse),
    IRAWAN: (_eval_irawan, _pdf_irawan),
    ROUGHDIFFUSE: (_eval_roughdiffuse, _pdf_diffuse),
    ROUGHCONDUCTOR: (_eval_roughconductor, _pdf_roughconductor),
    ROUGHDIELECTRIC: (_eval_roughdielectric, _pdf_roughdielectric),
    PLASTIC: (_eval_plastic, _pdf_plastic),
    COATING: (_eval_coating, _pdf_coating),
    ROUGHPLASTIC: (_eval_roughplastic, _pdf_roughplastic),
    PHONG: (_eval_phong, _pdf_phong),
    WARD: (_eval_ward, _pdf_ward),
    DIFFTRANS: (_eval_difftrans, _pdf_difftrans),
    HK: (_eval_hk, _pdf_hk),
}


def bsdf_eval_v(p: LaneParams3, wi: V3, wo: V3) -> V3:
    """f(wi, wo) * |cos_theta_o| over smooth components (delta types -> 0)."""
    wi, wo, _ = _maybe_flip(p, wi, wo)
    out = v.zeros(p.eta_s.shape)
    for t in p.used_types:
        if t in _EVAL:
            fn = _EVAL[t][0]
            out = v.where(p.type == t, fn(p, wi, wo) * p.opacity, out)
    return out


def bsdf_pdf_v(p: LaneParams3, wi: V3, wo: V3) -> jax.Array:
    """Solid-angle pdf of bsdf_sample landing at wo (smooth components)."""
    wi, wo, _ = _maybe_flip(p, wi, wo)
    out = jnp.zeros(p.eta_s.shape, p.eta_s.dtype)
    for t in p.used_types:
        if t in _EVAL:
            fn = _EVAL[t][1]
            out = jnp.where(p.type == t, fn(p, wi, wo) * p.opacity, out)
    return out


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def bsdf_sample_v(p: LaneParams3, wi: V3, u_lobe, u2a, u2b,
                  u_mask=None) -> BSDFSample3:
    """Importance-sample the full BSDF.  u_lobe chooses lobes, (u2a, u2b)
    drive the directional warp, u_mask (optional) drives mask-opacity
    passthrough."""
    wi_f, flip = _maybe_flip(p, wi)
    shape = p.eta_s.shape
    zero = jnp.zeros(shape, p.eta_s.dtype)
    one = jnp.ones(shape, p.eta_s.dtype)
    wo = V3(zero, zero, one)
    weight = v.zeros(shape)
    pdf = jnp.zeros(shape)
    delta = jnp.zeros(shape, bool)
    eta = jnp.ones(shape)

    ci = wi_f.z

    for t in p.used_types:
        sel = p.type == t
        if t == DIFFUSE or t == ROUGHDIFFUSE or t == IRAWAN:
            wo_t = v.square_to_cosine_hemisphere(u2a, u2b)
            pdf_t = v.square_to_cosine_hemisphere_pdf(wo_t)
            if t == DIFFUSE:
                w_t = _m3(ci > 0, p.refl)
            elif t == IRAWAN:
                ev = _eval_irawan(p, wi_f, wo_t)
                w_t = ev * safe_div(1.0, pdf_t)
            else:
                ev = _eval_roughdiffuse(p, wi_f, wo_t)
                w_t = ev * safe_div(1.0, pdf_t)
            wo, weight, pdf, delta, eta = _sel(
                sel,
                (wo_t, w_t, pdf_t, jnp.zeros(shape, bool), jnp.ones(shape)),
                (wo, weight, pdf, delta, eta),
            )
        elif t == CONDUCTOR:
            wo_t = v.reflect(wi_f)
            F = fresnel_conductor_v(ci, p.eta, p.k)
            w_t = _m3(ci > 0, p.spec * F)
            wo, weight, pdf, delta, eta = _sel(
                sel,
                (wo_t, w_t, jnp.ones(shape), jnp.ones(shape, bool),
                 jnp.ones(shape)),
                (wo, weight, pdf, delta, eta),
            )
        elif t in (ROUGHCONDUCTOR, ROUGHDIELECTRIC, ROUGHPLASTIC, PLASTIC,
                   PHONG, WARD, DIFFTRANS):
            out = _sample_smooth_family(t, p, wi_f, ci, u_lobe, u2a, u2b,
                                        shape)
            wo, weight, pdf, delta, eta = _sel(
                sel, out, (wo, weight, pdf, delta, eta)
            )
        elif t == COATING:
            # coating.cpp sampling: specular reflection w.p. F(wi), else a
            # cosine sample inside the coat refracted back out (exit-TIR
            # samples are lost, as in the reference)
            eta_c = p.eta_s
            F_i, _, _, _ = fresnel_dielectric(ci, eta_c)
            pick_spec = u_lobe < F_i
            wo_spec = v.reflect(wi_f)
            wo_in = v.square_to_cosine_hemisphere(u2a, u2b)
            tz2 = 1.0 - eta_c * eta_c * (1.0 - wo_in.z * wo_in.z)
            exits = tz2 > 0.0
            wo_sub = V3(eta_c * wo_in.x, eta_c * wo_in.y,
                        safe_sqrt(tz2)).normalized()
            co = jnp.maximum(wo_sub.z, 1e-6)
            F_o, _, _, _ = fresnel_dielectric(co, eta_c)
            ci_p = jnp.maximum(_coat_cos_inside(ci, eta_c), 1e-6)
            absorption = (p.trans * (-(1.0 / ci_p + 1.0 / wo_in.z))).exp()
            w_sub = _m3((ci > 0) & exits,
                        p.refl * absorption * (1.0 - F_o))
            pdf_sub = jnp.where(
                exits, (1.0 - F_i) * co * INV_PI / (eta_c * eta_c), 1.0)
            wo_t = v.where(pick_spec, wo_spec, wo_sub)
            w_t = v.where(pick_spec, p.spec, w_sub)
            pdf_t = jnp.where(pick_spec, 1.0, pdf_sub)
            wo, weight, pdf, delta, eta = _sel(
                sel, (wo_t, w_t, pdf_t, pick_spec, jnp.ones(shape)),
                (wo, weight, pdf, delta, eta),
            )
        elif t == DIELECTRIC:
            F, cos_t, eta_rel, eta_ti = fresnel_dielectric(ci, p.eta_s)
            refl = u_lobe < F
            wo_r = v.reflect(wi_f)
            n_up = V3(zero, zero, one)
            wo_t = v.refract_n(wi_f, n_up, eta_ti, cos_t).normalized()
            w_r = p.spec
            w_t = p.trans * (eta_ti * eta_ti)
            wo_d = v.where(refl, wo_r, wo_t)
            w_d = v.where(refl, w_r, w_t)
            eta_d = jnp.where(refl, 1.0, eta_rel)
            wo, weight, pdf, delta, eta = _sel(
                sel,
                (wo_d, w_d, jnp.ones(shape), jnp.ones(shape, bool), eta_d),
                (wo, weight, pdf, delta, eta),
            )
        elif t == THINDIELECTRIC:
            F, _, _, _ = fresnel_dielectric(jnp.abs(ci), p.eta_s)
            R = jnp.where(F < 1.0, 2.0 * F / (1.0 + F), 1.0)
            refl = u_lobe < R
            wo_d = v.where(refl, v.reflect(wi_f), -wi_f)
            w_d = v.where(refl, p.spec, p.trans)
            wo, weight, pdf, delta, eta = _sel(
                sel,
                (wo_d, w_d, jnp.ones(shape), jnp.ones(shape, bool),
                 jnp.ones(shape)),
                (wo, weight, pdf, delta, eta),
            )
        elif t == HK:
            # delta transmission vs cosine-sampled single scattering
            aci = jnp.maximum(jnp.abs(ci), 1e-4)
            pd = _hk_pdelta(p, aci)
            pick_delta = u_lobe < pd
            u_re = jnp.clip((u_lobe - pd) / jnp.maximum(1.0 - pd, 1e-8),
                            0.0, 0.999999)
            down = u_re < 0.5  # transmission side
            base = v.square_to_cosine_hemisphere(u2a, u2b)
            sgn = jnp.where(down, -jnp.sign(ci), jnp.sign(ci))
            wo_s = V3(base.x, base.y, base.z * sgn)
            pdf_s = (1.0 - pd) * 0.5 * jnp.abs(wo_s.z) * INV_PI
            w_s = _eval_hk(p, wi_f, wo_s) * safe_div(1.0, pdf_s)
            att = (p.trans * (-1.0 / aci)).exp()
            w_d = att * (1.0 / jnp.maximum(pd, 1e-8))
            wo_t = v.where(pick_delta, -wi_f, wo_s)
            w_t = v.where(pick_delta, w_d, w_s)
            pdf_t = jnp.where(pick_delta, 1.0, jnp.maximum(pdf_s, 1e-20))
            wo, weight, pdf, delta, eta = _sel(
                sel, (wo_t, w_t, pdf_t, pick_delta, jnp.ones(shape)),
                (wo, weight, pdf, delta, eta),
            )
        elif t == NULL_BSDF:
            wo, weight, pdf, delta, eta = _sel(
                sel,
                (-wi_f, v.ones(shape), jnp.ones(shape),
                 jnp.ones(shape, bool), jnp.ones(shape)),
                (wo, weight, pdf, delta, eta),
            )

    null_pass = jnp.zeros(shape, bool)
    for t in p.used_types:
        if t == NULL_BSDF:
            null_pass = null_pass | (p.type == t)

    # mask opacity passthrough: with prob 1-opacity go straight through
    if u_mask is not None:
        passthrough = u_mask >= p.opacity
        wo = v.where(passthrough, -wi_f, wo)
        weight = v.where(passthrough, v.ones(shape), weight)
        pdf = jnp.where(passthrough, 1.0, pdf)
        delta = jnp.where(passthrough, True, delta)
        eta = jnp.where(passthrough, 1.0, eta)
        null_pass = null_pass | passthrough

    # un-flip for twosided lanes
    fz = jnp.where(flip, -1.0, 1.0)
    wo = V3(wo.x, wo.y, wo.z * fz)
    return BSDFSample3(wo=wo, weight=weight, pdf=pdf, delta=delta, eta=eta,
                       null_passthrough=null_pass)


def _sel(mask, new, old):
    out = []
    for n, o in zip(new, old):
        if isinstance(n, V3):
            out.append(v.where(mask, n, o))
        else:
            out.append(jnp.where(mask, n, o))
    return tuple(out)


def _sample_smooth_family(t, p, wi, ci, u_lobe, u2a, u2b, shape):
    """Types sampled by 'draw direction, weight = eval/pdf'."""
    if t == ROUGHCONDUCTOR:
        h, _ = mf.sample_visible_v(p.dist, wi, p.alpha_u, p.alpha_v, u2a, u2b)
        wo = v.reflect_n(wi, h).normalized()
    elif t == ROUGHDIELECTRIC:
        wi_up = v.where(ci < 0, -wi, wi)
        h, _ = mf.sample_visible_v(p.dist, wi_up, p.alpha_u, p.alpha_v,
                                   u2a, u2b)
        c = wi.dot(h)
        F, cos_t, eta_rel, eta_ti = fresnel_dielectric(c, p.eta_s)
        refl = u_lobe < F
        wo_r = v.reflect_n(wi, h).normalized()
        wo_t = (h * (eta_ti * c + cos_t) - wi * eta_ti).normalized()
        wo = v.where(refl, wo_r, wo_t)
        # hemisphere rejection as in the reference roughdielectric.cpp:
        # reflection must stay on wi's side, transmission must cross.
        same_side = wi.z * wo.z > 0
        side_ok = jnp.where(refl, same_side, ~same_side)
        ev = _eval_roughdielectric(p, wi, wo)
        pdf = _pdf_roughdielectric(p, wi, wo)
        w = ev * safe_div(1.0, pdf)
        eta_out = jnp.where(refl, 1.0, eta_rel)
        ok = (pdf > 1e-12) & side_ok
        return (wo, _m3(ok, w), jnp.maximum(pdf, 1e-20),
                jnp.zeros(shape, bool), eta_out)
    elif t in (PLASTIC, ROUGHPLASTIC):
        Fi, _, _, _ = fresnel_dielectric(ci, p.eta_s)
        if t == ROUGHPLASTIC:
            prob_spec = _prob_specular_rough(p, ci)
        else:
            prob_spec = _prob_specular(p, Fi)
        pick_spec = u_lobe < prob_spec
        wo_d = v.square_to_cosine_hemisphere(u2a, u2b)
        if t == PLASTIC:
            wo_s = v.reflect(wi)
            # specular lobe is delta
            w_spec = p.spec * (Fi / jnp.maximum(prob_spec, 1e-8))
            diff_val = _eval_plastic(p, wi, wo_d)
            pdf_d = v.square_to_cosine_hemisphere_pdf(wo_d) * (1.0 - prob_spec)
            w_diff = diff_val * safe_div(1.0, pdf_d)
            wo = v.where(pick_spec, wo_s, wo_d)
            w = v.where(pick_spec, w_spec, w_diff)
            pdf = jnp.where(pick_spec, 1.0, jnp.maximum(pdf_d, 1e-20))
            valid = (ci > 0) & ((pick_spec) | (pdf > 1e-12))
            return (wo, _m3(valid, w), pdf, pick_spec, jnp.ones(shape))
        else:
            h, _ = mf.sample_visible_v(p.dist, wi, p.alpha_u, p.alpha_v,
                                       u2a, u2b)
            wo_s = v.reflect_n(wi, h).normalized()
            wo = v.where(pick_spec, wo_s, wo_d)
    elif t == PHONG:
        sw = _spec_sampling_weight(p)
        pick_spec = u_lobe < sw
        n = p.exponent
        ct = jnp.power(jnp.maximum(u2a, 1e-20), 1.0 / (n + 1.0))
        st = safe_sqrt(1.0 - ct * ct)
        phi = 2.0 * jnp.pi * u2b
        local = V3(st * jnp.cos(phi), st * jnp.sin(phi), ct)
        r = v.reflect(wi)
        fr = v.frame_from_normal(r.normalized())
        wo_s = v.to_world(fr, local)
        wo_d = v.square_to_cosine_hemisphere(u2a, u2b)
        wo = v.where(pick_spec, wo_s, wo_d)
    elif t == WARD:
        sw = _spec_sampling_weight(p)
        pick_spec = u_lobe < sw
        au, av = p.alpha_u, p.alpha_v
        phi_h = jnp.arctan2(av * jnp.sin(2 * jnp.pi * u2b),
                            au * jnp.cos(2 * jnp.pi * u2b))
        cp, sp = jnp.cos(phi_h), jnp.sin(phi_h)
        denom = cp * cp / (au * au) + sp * sp / (av * av)
        t2 = -jnp.log(jnp.maximum(u2a, 1e-20)) / jnp.maximum(denom, 1e-12)
        ct = jax.lax.rsqrt(1.0 + t2)
        st = safe_sqrt(1.0 - ct * ct)
        h = V3(st * cp, st * sp, ct)
        wo_s = v.reflect_n(wi, h).normalized()
        wo_d = v.square_to_cosine_hemisphere(u2a, u2b)
        wo = v.where(pick_spec, wo_s, wo_d)
    elif t == DIFFTRANS:
        # cosine hemisphere on the side opposite wi
        base = v.square_to_cosine_hemisphere(u2a, u2b)
        sign = jnp.where(ci > 0, -1.0, 1.0)
        wo = V3(base.x, base.y, base.z * sign)
    else:
        raise AssertionError(t)

    evf, pdff = _EVAL[t]
    ev = evf(p, wi, wo)
    pdf = pdff(p, wi, wo)
    ok = pdf > 1e-12
    w = ev * safe_div(1.0, pdf)
    return (wo, _m3(ok, w), jnp.maximum(pdf, 1e-20),
            jnp.zeros(shape, bool), jnp.ones(shape))


# ---------------------------------------------------------------------------
# (..., 3)-array compatibility wrappers (old public API)
# ---------------------------------------------------------------------------

def bsdf_eval(p: LaneParams, wi, wo) -> jax.Array:
    return bsdf_eval_v(lane_params_to_v(p), V3.from_array(wi),
                       V3.from_array(wo)).to_array()


def bsdf_pdf(p: LaneParams, wi, wo) -> jax.Array:
    return bsdf_pdf_v(lane_params_to_v(p), V3.from_array(wi),
                      V3.from_array(wo))


def bsdf_sample(p: LaneParams, wi, u_lobe, u2, u_mask=None) -> BSDFSample:
    bs = bsdf_sample_v(lane_params_to_v(p), V3.from_array(wi), u_lobe,
                       u2[..., 0], u2[..., 1], u_mask)
    return BSDFSample(
        wo=bs.wo.to_array(), weight=bs.weight.to_array(), pdf=bs.pdf,
        delta=bs.delta, eta=bs.eta, null_passthrough=bs.null_passthrough,
    )
