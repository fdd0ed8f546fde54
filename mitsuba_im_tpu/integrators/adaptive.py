"""Adaptive sampling wrapper (reference ``src/integrators/misc/adaptive.cpp``).

The reference stops sampling a pixel block once a Student-t confidence
interval of the running mean falls below ``maxError`` relative to the pixel
luminance, up to ``maxSampleFactor`` x the base sample count.  Wavefront
reframe: per-pixel Welford accumulators (mean image + luminance M2 + count)
live in device arrays; sampling proceeds in checkpointed rounds of the base
spp; after each round the converged pixels are dropped and the *remaining
active pixel ids are compacted into the next power-of-two bucket*, so later
rounds launch proportionally smaller wavefronts (bounded number of XLA
compilations, real wall-clock savings — the analog of the reference's
per-block early stop).

Like the reference, stopping on a pixel's own statistics introduces a small
bias for very low sample counts (adaptive.cpp documents the same caveat);
reconstruction is box (per-pixel independence is what makes the t-test
valid).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import functools

from ..core.types import Float, Int
from ..core import rng as mrng
from ..sampler import KIND_BY_NAME
from ..sensor.table import sample_ray


def _student_t_quantile(p: float, dof: float) -> float:
    """Two-sided Student-t quantile via the Cornish-Fisher expansion around
    the normal quantile (Hill 1970); plenty accurate for dof >= 4, which the
    base spp guarantees (analog of boost::math::quantile in adaptive.cpp)."""
    # normal quantile (Acklam's rational approximation)
    z = _norm_quantile(1.0 - p / 2.0)
    v = max(dof, 1.0)
    z3, z5, z7 = z ** 3, z ** 5, z ** 7
    t = (z
         + (z3 + z) / (4 * v)
         + (5 * z5 + 16 * z3 + 3 * z) / (96 * v * v)
         + (3 * z7 + 19 * z5 + 17 * z3 - 15 * z) / (384 * v ** 3))
    return float(t)


def _norm_quantile(p: float) -> float:
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = np.sqrt(-2 * np.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        return -_norm_quantile(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "kind", "li_fn", "n_rounds"),
    donate_argnames=("mean", "m2", "count"),
)
def _adaptive_round(scene, pix, mean, m2, count, sample0, seed, n_rounds,
                    *, width, height, spp, kind, li_fn):
    """Run ``n_rounds`` one-sample passes over the (compacted) pixel batch,
    updating Welford accumulators via scatter at the pixel ids."""

    def body(carry, s_idx):
        mean, m2, count = carry
        sampler = mrng.make_sampler(pix, s_idx, seed, kind=kind, spp=spp)
        sampler, blk0 = mrng.next_block4(sampler)
        jitter, u_lens = blk0[..., :2], blk0[..., 2:4]
        px = (pix % width).astype(Float)
        py = (pix // width).astype(Float)
        uv = (jnp.stack([px, py], -1) + jitter) / jnp.asarray(
            [width, height], Float)
        o, d, w_sensor = sample_ray(scene.sensor, uv, u_lens)
        li, _ = li_fn(scene, sampler, o, d)
        li = jnp.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0)
        li = li * w_sensor[..., None]
        lum = (li[..., 0] * 0.212671 + li[..., 1] * 0.715160
               + li[..., 2] * 0.072169)

        # Welford update at the scattered pixel ids
        c_old = count[pix]
        c_new = c_old + 1.0
        mu_old = mean[pix]
        delta = li - mu_old
        mu_new = mu_old + delta / c_new[..., None]
        lum_mu_old = (mu_old[..., 0] * 0.212671 + mu_old[..., 1] * 0.715160
                      + mu_old[..., 2] * 0.072169)
        lum_mu_new = (mu_new[..., 0] * 0.212671 + mu_new[..., 1] * 0.715160
                      + mu_new[..., 2] * 0.072169)
        m2_new = m2[pix] + (lum - lum_mu_old) * (lum - lum_mu_new)

        mean = mean.at[pix].set(mu_new)
        m2 = m2.at[pix].set(m2_new)
        count = count.at[pix].set(c_new)
        return (mean, m2, count), None

    (mean, m2, count), _ = jax.lax.scan(
        body, (mean, m2, count),
        sample0 + jnp.arange(n_rounds, dtype=jnp.uint32))
    return mean, m2, count


def render_adaptive(scene, settings, spp=None):
    """Adaptive render -> (H, W, 3) numpy image.

    ``spp`` (sampleCount) is the per-round batch; sampling continues per
    pixel until t * stderr <= maxError * max(|mean lum|, quantile floor) at
    confidence 1 - pValue, or maxSampleFactor rounds (adaptive.cpp
    semantics with maxSampleFactor capping total budget)."""
    ip = settings.integrator_props
    max_error = float(ip.get("max_error", 0.05))
    p_value = float(ip.get("p_value", 0.05))
    max_factor = int(ip.get("max_spp", 32))
    nested = dict(ip.get("nested", {"name": "path"}))

    from ..scene.build import RenderSettings
    from ..render.job import _integrator_fn

    sub = RenderSettings(integrator=nested.pop("name", "path"),
                         integrator_props=nested)
    li_fn = _integrator_fn(sub)

    base_spp = int(spp if spp is not None else settings.spp)
    W, H = settings.width, settings.height
    n = W * H
    kind = KIND_BY_NAME.get(settings.sampler, mrng.INDEPENDENT)

    mean = jnp.zeros((n, 3), Float)
    m2 = jnp.zeros((n,), Float)
    count = jnp.zeros((n,), Float)

    pix_active = np.arange(n, dtype=np.uint32)
    sample0 = 0
    for round_idx in range(max_factor):
        if len(pix_active) == 0:
            break
        # compact into a power-of-two bucket (bounded recompilation)
        bucket = max(1 << int(np.ceil(np.log2(max(len(pix_active), 1)))), 256)
        bucket = min(bucket, n)
        pad = np.zeros(bucket - len(pix_active), np.uint32)  # pixel 0 pads
        pix = jnp.asarray(np.concatenate([pix_active, pad]))
        mean, m2, count = _adaptive_round(
            scene, pix, mean, m2, count, jnp.uint32(sample0),
            jnp.uint32(settings.seed), base_spp,
            width=W, height=H, spp=base_spp, kind=kind, li_fn=li_fn,
        )
        sample0 += base_spp

        cnt = np.asarray(count[pix_active])
        mu = np.asarray(mean[pix_active])
        var = np.asarray(m2[pix_active]) / np.maximum(cnt - 1.0, 1.0)
        stderr = np.sqrt(var / np.maximum(cnt, 1.0))
        tq = _student_t_quantile(p_value, sample0 - 1.0)
        lum = mu @ np.array([0.212671, 0.715160, 0.072169], np.float32)
        floor = max(np.percentile(lum, 50) * 0.1, 1e-3)
        ok = tq * stderr <= max_error * np.maximum(np.abs(lum), floor)
        pix_active = pix_active[~ok]

    img = np.asarray(mean).reshape(H, W, 3)
    return img
