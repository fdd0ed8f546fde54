"""Irawan & Marschner woven-cloth BRDF.

Parity target: ``/root/reference/src/bsdfs/irawan.{h,cpp}`` — the
procedural woven-cloth model from Piti Irawan's thesis ("The Appearance
of Woven Cloth"): a weave pattern tiles the UV plane into warp/weft yarn
segments; each segment gets a curved-cylinder specular highlight
(filament or staple yarn) plus a diffuse floor, with optional correlated
noise on the inclination angle and per-fiber intensity variation.

The weave description is *static* scene data (a few dozen scalars), so it
compiles into the kernel as constants: per-lane cell lookup and per-yarn
parameter resolution lower to short fused select chains — no gathers on
the hot path.  The weave-pattern DSL parser accepts the reference's file
format (irawan.h WeavePatternGrammar), including ``$var`` substitution
from the enclosing Properties and ``/* */`` comments; angles in files are
degrees (converted here, as in YarnGrammar).
"""
from __future__ import annotations

import dataclasses
import functools
import re

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import Float
from ..core import v3 as v
from ..core.v3 import V3

INV_PI = 1.0 / np.pi
WARP, WEFT = 0, 1


@dataclasses.dataclass(frozen=True)
class Yarn:
    """One yarn segment prototype (irawan.h struct Yarn); angles in
    radians, kd/ks as linear-RGB tuples."""
    type: int = WARP
    psi: float = 0.0
    umax: float = 0.0
    kappa: float = 0.0
    width: float = 0.0
    length: float = 0.0
    centerU: float = 0.0
    centerV: float = 0.0
    kd: tuple = (0.0, 0.0, 0.0)
    ks: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class WeavePattern:
    """Weave description (irawan.h struct WeavePattern) + instance
    parameters (repeatU/V, normalization) — hashable so it can ride as
    static aux data on the BSDF lane params."""
    name: str = ""
    alpha: float = 0.0
    beta: float = 0.0
    ss: float = 0.0
    hWidth: float = 0.0
    warpArea: float = 0.0
    weftArea: float = 0.0
    tileWidth: int = 1
    tileHeight: int = 1
    dWarpUmaxOverDWarp: float = 0.0
    dWarpUmaxOverDWeft: float = 0.0
    dWeftUmaxOverDWarp: float = 0.0
    dWeftUmaxOverDWeft: float = 0.0
    fineness: float = 0.0
    period: float = 0.0
    pattern: tuple = (1,)
    yarns: tuple = (Yarn(),)
    repeatU: float = 1.0
    repeatV: float = 1.0
    normalization: float = 1.0


# ---------------------------------------------------------------------------
# DSL parser (irawan.h SkipGrammar/YarnGrammar/WeavePatternGrammar)
# ---------------------------------------------------------------------------

_DEG_KEYS_YARN = ("psi", "umax")
_DEG_KEYS_WEAVE = ("dWarpUmaxOverDWarp", "dWarpUmaxOverDWeft",
                   "dWeftUmaxOverDWarp", "dWeftUmaxOverDWeft")


def _strip_comments(text: str) -> str:
    return re.sub(r"/\*.*?\*/", " ", text, flags=re.S)


def _value(tok: str, props):
    tok = tok.strip()
    if tok.startswith("$"):
        if props is None:
            raise ValueError(f"weave parameter {tok} needs Properties")
        return props.get_float(tok[1:])
    return float(tok)


def _spectrum(tok: str, props):
    tok = tok.strip()
    if tok.startswith("$"):
        return tuple(float(x) for x in np.asarray(props.get_spectrum(tok[1:])))
    m = re.match(r"\{([^}]*)\}", tok)
    if not m:
        raise ValueError(f"bad spectrum literal: {tok!r}")
    parts = [float(x) for x in m.group(1).split(",")]
    return tuple(parts[:3])


def _split_top(body: str) -> list[str]:
    """Split on commas at brace depth 0."""
    out, depth, cur = [], 0, []
    for ch in body:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        out.append("".join(cur))
    return out


def _match_block(text: str, start: int) -> tuple[str, int]:
    """Return (contents, end_index) of the brace block opening at/after
    ``start``."""
    i = text.index("{", start)
    depth, j = 1, i + 1
    while depth:
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
        j += 1
    return text[i + 1:j - 1], j


def parse_weave(text: str, props=None, repeatU=1.0, repeatV=1.0) -> WeavePattern:
    """Parse the reference weave-pattern DSL into a WeavePattern."""
    text = _strip_comments(text)
    m = re.search(r"\bweave\b", text)
    if not m:
        raise ValueError("no 'weave { ... }' block found")
    body, _ = _match_block(text, m.end())

    fields: dict = {}
    yarns: list[Yarn] = []
    pattern: tuple = ()
    for item in _split_top(body):
        item = item.strip()
        if not item:
            continue
        if item.startswith("yarn"):
            ybody, _ = _match_block(item, 4)
            yf: dict = {}
            for kv in _split_top(ybody):
                if not kv.strip():
                    continue
                k, _, val = kv.partition("=")
                k = k.strip()
                val = val.strip()
                if k == "type":
                    yf["type"] = WARP if val == "warp" else WEFT
                elif k in ("kd", "ks"):
                    yf[k] = _spectrum(val, props)
                else:
                    x = _value(val, props)
                    if k in _DEG_KEYS_YARN:
                        x = x * np.pi / 180.0
                    yf[k] = x
            yarns.append(Yarn(**yf))
        elif item.startswith("pattern"):
            pbody, _ = _match_block(item, 7)
            pattern = tuple(int(x) for x in pbody.replace("\n", " ")
                            .split(",") if x.strip())
        else:
            k, _, val = item.partition("=")
            k = k.strip()
            val = val.strip()
            if k == "name":
                fields["name"] = val.strip().strip('"')
            elif k in ("tileWidth", "tileHeight"):
                fields[k] = int(float(val))
            else:
                x = _value(val, props)
                if k in _DEG_KEYS_WEAVE:
                    x = x * np.pi / 180.0
                fields[k] = x

    pat = WeavePattern(pattern=pattern, yarns=tuple(yarns),
                       repeatU=repeatU, repeatV=repeatV, **fields)
    if len(pat.pattern) != pat.tileWidth * pat.tileHeight:
        raise ValueError("pattern size != tileWidth * tileHeight")
    for pv in pat.pattern:
        if not (0 < pv <= len(pat.yarns)):
            raise ValueError(f"pattern entry {pv} out of yarn range")
    return pat


# A synthetic plain-weave preset (1/1 checkerboard interlacing) so the
# plugin works without an external pattern file; parameter magnitudes
# follow the model's documented ranges (irawan.h comments).
PLAIN_WEAVE = """
weave {
  name = "built-in plain weave",
  /* Fiber scattering */
  alpha = 0.3, beta = 6.0, ss = 0.0, hWidth = 0.5,
  warpArea = 1.0, weftArea = 1.0,
  tileWidth = 2, tileHeight = 2,
  fineness = 0.0, period = 0.0,
  pattern { 1, 2, 2, 1 },
  yarn { type = warp, psi = 0, umax = 35, kappa = 0.5,
         width = 1.0, length = 1.0, centerU = 0.5, centerV = 0.5,
         kd = {0.3, 0.3, 0.3}, ks = {0.4, 0.4, 0.4} },
  yarn { type = weft, psi = 0, umax = 35, kappa = 0.5,
         width = 1.0, length = 1.0, centerU = 0.5, centerV = 0.5,
         kd = {0.3, 0.3, 0.3}, ks = {0.4, 0.4, 0.4} }
}
"""


# ---------------------------------------------------------------------------
# Numeric helpers (qmc.h sampleTEA*, libcore noise.cpp Perlin, irawan.cpp
# vonMises/seeliger/radiusOfCurvature)
# ---------------------------------------------------------------------------

def sample_tea_float(v0, v1, rounds: int = 8):
    """TEA-hash uniform in [0,1) (qmc.h:146-183; irawan uses 8 rounds)."""
    v0 = jnp.asarray(v0, jnp.uint32)
    v1 = jnp.asarray(v1, jnp.uint32)
    s = jnp.uint32(0)
    for _ in range(rounds):
        s = s + jnp.uint32(0x9E3779B9)
        v0 = v0 + (((v1 << 4) + jnp.uint32(0xA341316C))
                   ^ (v1 + s) ^ ((v1 >> 5) + jnp.uint32(0xC8013EA4)))
        v1 = v1 + (((v0 << 4) + jnp.uint32(0xAD90777D))
                   ^ (v0 + s) ^ ((v0 >> 5) + jnp.uint32(0x7E95761E)))
    bits = (v0 >> 9) | jnp.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(bits, jnp.float32) - 1.0


# Ken Perlin's reference permutation (public domain, "Improved Noise").
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3,
    64, 52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85,
    212, 207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170,
    213, 119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43,
    172, 9, 129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185,
    112, 104, 218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191,
    179, 162, 241, 81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31,
    181, 199, 106, 157, 184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150,
    254, 138, 236, 205, 93, 222, 114, 67, 29, 24, 72, 243, 141, 128, 195,
    78, 66, 215, 61, 156, 180,
], np.int32)
# 1D slice of improved Perlin noise (y=z=0): lattice gradients reduce to
# grad(hash(X), x-lattice) with the standard 12-direction gradient set.
_H0 = _PERM[(_PERM[_PERM % 256] % 256)]  # hash of (X, 0, 0) per lattice X


def _grad1(h, x):
    """grad() of improved noise at y=z=0: contributions from the x term
    only survive when the gradient direction includes ±x."""
    h = h & 15
    u = jnp.where(h < 8, x, 0.0)
    # v-term source: y for h<4 (zero here), else z (zero) or x for 12/14
    vv = jnp.where((h == 12) | (h == 14), x, 0.0)
    return (jnp.where(h & 1 == 0, u, -u)
            + jnp.where(h & 2 == 0, vv, -vv))


def perlin_noise_1d(x):
    """Improved Perlin noise evaluated at (x, 0, 0) (libcore noise.cpp)."""
    xf = jnp.floor(x)
    xi = (xf.astype(jnp.int32) & 255)
    xr = x - xf
    fade = xr * xr * xr * (xr * (xr * 6.0 - 15.0) + 10.0)
    h0 = jnp.asarray(_H0, jnp.int32)[xi]
    h1 = jnp.asarray(_H0, jnp.int32)[(xi + 1) & 255]
    g0 = _grad1(h0, xr)
    g1 = _grad1(h1, xr - 1.0)
    return g0 + fade * (g1 - g0)


def _von_mises(cos_x, b):
    """Von Mises pdf with I0 via the Abramowitz-Stegun polynomial
    (irawan.cpp vonMises)."""
    absB = abs(float(b))
    if absB <= 3.75:
        t = (absB / 3.75) ** 2
        i0 = 1.0 + t * (3.5156229 + t * (3.0899424 + t * (1.2067492
              + t * (0.2659732 + t * (0.0360768 + t * 0.0045813)))))
    else:
        t = 3.75 / absB
        i0 = (np.exp(absB) / np.sqrt(absB)) * (0.39894228 + t * (0.01328592
              + t * (0.00225319 + t * (-0.00157565 + t * (0.00916281
              + t * (-0.02057706 + t * (0.02635537 + t * (-0.01647633
              + t * 0.00392377))))))))
    return jnp.exp(b * cos_x) / (2.0 * np.pi * i0)


def _seeliger(c1, c2):
    """Lommel-Seeliger attenuation, albedo 1 (irawan.cpp seeliger)."""
    c1 = jnp.maximum(c1, 0.0)
    c2 = jnp.maximum(c2, 0.0)
    return jnp.where((c1 > 0.0) & (c2 > 0.0),
                     (1.0 / (4.0 * np.pi)) * c1 * c2
                     / jnp.maximum(c1 + c2, 1e-20), 0.0)


def _smoothstep(x):
    x = jnp.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _radius_of_curvature(u, umax, kappa, w, l):
    """Spine radius of curvature; ellipse/parabola/hyperbola cases by
    rhat (irawan.cpp radiusOfCurvature; thesis §5.3).  All branches are
    evaluated with guarded inputs and selected."""
    rhat = 1.0 + kappa * (1.0 + 1.0 / jnp.tan(umax))
    a = 0.5 * w
    sin_umax = jnp.sin(umax)

    # circle (rhat == 1)
    r_circle = (0.5 * l - a * sin_umax) / jnp.maximum(sin_umax, 1e-20)

    # ellipse (rhat > 0)
    rh_e = jnp.maximum(rhat, 1e-6)
    tmax_e = jnp.arctan(rh_e * jnp.tan(umax))
    bhat_e = (0.5 * l - a * sin_umax) / jnp.maximum(jnp.sin(tmax_e), 1e-20)
    ahat_e = bhat_e / rh_e
    t_e = jnp.arctan(rh_e * jnp.tan(u))
    r_ellipse = (bhat_e ** 2 * jnp.cos(t_e) ** 2
                 + ahat_e ** 2 * jnp.sin(t_e) ** 2) ** 1.5 \
        / jnp.maximum(ahat_e * bhat_e, 1e-20)

    # hyperbola (rhat < 0)
    rh_h = jnp.minimum(rhat, -1e-6)
    atanh = lambda z: 0.5 * jnp.log(jnp.maximum(
        (1.0 + z) / jnp.maximum(1.0 - z, 1e-20), 1e-20))
    th = jnp.clip(rh_h * jnp.tan(umax), -0.999999, 0.999999)
    tmax_h = -atanh(th)
    bhat_h = (0.5 * l - a * sin_umax) / jnp.maximum(jnp.sinh(tmax_h), 1e-20)
    ahat_h = bhat_h / rh_h
    t_h = -atanh(jnp.clip(rh_h * jnp.tan(u), -0.999999, 0.999999))
    r_hyper = -(bhat_h ** 2 * jnp.cosh(t_h) ** 2
                + ahat_h ** 2 * jnp.sinh(t_h) ** 2) ** 1.5 \
        / (ahat_h * bhat_h)

    # parabola (rhat == 0)
    tmax_p = jnp.tan(umax)
    ahat_p = (0.5 * l - a * sin_umax) / jnp.maximum(2.0 * tmax_p, 1e-20)
    t_p = jnp.tan(u)
    r_parab = 2.0 * ahat_p * (1.0 + t_p * t_p) ** 1.5

    return jnp.where(
        rhat == 1.0, r_circle,
        jnp.where(rhat > 0.0, r_ellipse,
                  jnp.where(rhat < 0.0, r_hyper, r_parab)))


# ---------------------------------------------------------------------------
# Per-cell static parameter tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _cell_tables(pat: WeavePattern):
    """Expand pattern cells -> per-cell yarn parameter arrays (numpy;
    compile-time constants)."""
    yid = np.asarray(pat.pattern, np.int32) - 1
    ys = pat.yarns
    col = lambda f: np.asarray([f(ys[i]) for i in yid], np.float32)
    return dict(
        is_weft=col(lambda y: float(y.type == WEFT)),
        psi=col(lambda y: y.psi),
        umax=col(lambda y: y.umax),
        kappa=col(lambda y: y.kappa),
        w=col(lambda y: y.width),
        l=col(lambda y: y.length),
        centerU=col(lambda y: y.centerU),
        centerV=col(lambda y: y.centerV),
        kd=np.asarray([ys[i].kd for i in yid], np.float32),
        ks=np.asarray([ys[i].ks for i in yid], np.float32),
    )


def _cell_select(cell, arr):
    """Per-lane select chain over the (small) cell table."""
    out = jnp.zeros(cell.shape, Float) + float(arr[0])
    for i in range(1, arr.shape[0]):
        out = jnp.where(cell == i, float(arr[i]), out)
    return out


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def eval_pattern(pat: WeavePattern, uv_u, uv_v, wi: V3, wo: V3,
                 initialization: bool = False):
    """Cloth BRDF f(wi,wo)*cos_o for one weave pattern (irawan.cpp eval).

    Directions in the local shading frame.  In ``initialization`` mode
    returns the *unnormalized specular scalar* (irawan.cpp
    m_initialization pre-pass) used to compute ``pat.normalization``.
    """
    tw, th = pat.tileWidth, pat.tileHeight
    tab = _cell_tables(pat)

    uu = uv_u * pat.repeatU
    vv = (1.0 - uv_v) * pat.repeatV
    x = uu * tw
    y = vv * th
    # (int) casts in the reference truncate; uv >= 0 in practice, and the
    # mod folds negatives correctly anyway
    xi = jnp.floor(x)
    yi = jnp.floor(y)
    lx = jnp.mod(xi.astype(jnp.int32), tw)
    ly = jnp.mod(yi.astype(jnp.int32), th)
    cell = lx + ly * tw

    g = lambda k: _cell_select(cell, tab[k])
    is_weft = g("is_weft") > 0.5
    psi = g("psi")
    umax = g("umax")
    kappa = g("kappa")
    w_ = g("w")
    l_ = g("l")

    cx = (xi // tw) * tw + g("centerU") * tw
    cy = (yi // th) * th + (1.0 - g("centerV")) * th
    rx = x - cx
    ry = -(y - cy)

    # weft: rotate coordinates and directions pi/2 about z
    xx = jnp.where(is_weft, -ry, rx)
    yy = jnp.where(is_weft, rx, ry)
    oix = jnp.where(is_weft, -wi.y, wi.x)
    oiy = jnp.where(is_weft, wi.x, wi.y)
    orx = jnp.where(is_weft, -wo.y, wo.x)
    ory = jnp.where(is_weft, wo.x, wo.y)
    om_i = V3(oix, oiy, wi.z)
    om_r = V3(orx, ory, wo.z)

    # correlated noise on the inclination angle (period > 0)
    if pat.period > 0.0:
        pos_x = cx.astype(jnp.uint32)
        pos_y = cy.astype(jnp.uint32)
        r1 = perlin_noise_1d(
            (cx * (th * pat.repeatV
                   + sample_tea_float(pos_x, 2 * pos_y)) + cy) / pat.period)
        r2 = perlin_noise_1d(
            (cy * (tw * pat.repeatU
                   + sample_tea_float(pos_x, 2 * pos_y + 1)) + cx)
            / pat.period)
        d_warp = jnp.where(is_weft, pat.dWeftUmaxOverDWarp,
                           pat.dWarpUmaxOverDWarp)
        d_weft = jnp.where(is_weft, pat.dWeftUmaxOverDWeft,
                           pat.dWarpUmaxOverDWeft)
        umax = umax + r1 * d_warp + r2 * d_weft

    u_ = yy / (l_ / 2.0) * umax
    v_ = xx * np.pi / w_

    if any(y.psi != 0.0 for y in pat.yarns):
        stap = _staple_integrand(pat, u_, v_, om_i, om_r, psi, umax,
                                 kappa, w_, l_)
    else:
        stap = None
    if any(y.psi == 0.0 for y in pat.yarns):
        fil = _filament_integrand(pat, u_, v_, om_i, om_r, umax, kappa,
                                  w_, l_)
    else:
        fil = None
    if stap is None:
        integrand = fil
    elif fil is None:
        integrand = stap
    else:
        integrand = jnp.where(psi != 0.0, stap, fil)

    # per-fiber intensity variation (fineness > 0)
    if pat.fineness > 0.0:
        i1 = ((cx + xx) * pat.fineness).astype(jnp.uint32)
        i2 = ((cy + yy) * pat.fineness).astype(jnp.uint32)
        xi_ = sample_tea_float(i1, i2)
        iv = jnp.minimum(-jnp.log(jnp.maximum(xi_, 1e-20)), 10.0)
    else:
        iv = 1.0

    ratio = jnp.where(
        is_weft,
        (pat.warpArea + pat.weftArea) / max(pat.weftArea, 1e-20),
        (pat.warpArea + pat.weftArea) / max(pat.warpArea, 1e-20))
    spec_scalar = iv * integrand * ratio

    front = (wi.z > 0.0) & (wo.z > 0.0)
    if initialization:
        return jnp.where(front, spec_scalar, 0.0)

    ks = V3(_cell_select(cell, tab["ks"][:, 0]),
            _cell_select(cell, tab["ks"][:, 1]),
            _cell_select(cell, tab["ks"][:, 2]))
    kd = V3(_cell_select(cell, tab["kd"][:, 0]),
            _cell_select(cell, tab["kd"][:, 1]),
            _cell_select(cell, tab["kd"][:, 2]))
    out = (ks * (spec_scalar * pat.normalization) + kd * INV_PI) * wo.z
    return v.where(front, out, v.zeros(uv_u.shape))


def _filament_integrand(pat, u_, v_, om_i, om_r, umax, kappa, w_, l_):
    """irawan.cpp evalFilamentIntegrand (psi = 0 yarns)."""
    ss = pat.ss
    if ss < 0.0 or ss >= 1.0:
        return jnp.zeros(u_.shape, Float)

    h = (om_r + om_i).normalized()
    u_of_v = jnp.arctan2(h.y, jnp.maximum(h.z, 1e-20))
    in_range = jnp.abs(u_of_v) < umax

    n = V3(jnp.sin(v_), jnp.sin(u_of_v) * jnp.cos(v_),
           jnp.cos(u_of_v) * jnp.cos(v_)).normalized()
    t = V3(jnp.zeros_like(u_of_v), jnp.cos(u_of_v),
           -jnp.sin(u_of_v)).normalized()

    R = _radius_of_curvature(
        jnp.minimum(jnp.abs(u_of_v), (1.0 - ss) * umax),
        (1.0 - ss) * umax, kappa, w_, l_)

    a = 0.5 * w_
    s = om_i + om_r
    tch_x = t.cross(h).x
    Gu = a * (R + a * jnp.cos(v_)) \
        / jnp.maximum(s.norm() * jnp.abs(tch_x), 1e-20)

    fc = pat.alpha + _von_mises(-om_i.dot(om_r), pat.beta)
    A = _seeliger(n.dot(om_i), n.dot(om_r))
    if ss == 0.0:
        As = A
    else:
        As = A * (1.0 - _smoothstep(
            (jnp.abs(u_of_v) - (1.0 - ss) * umax) / (ss * umax)))
    fs = Gu * fc * As * np.pi * l_

    delta_y = l_ * pat.hWidth
    y_of_v = jnp.clip(u_of_v * 0.5 * l_ / umax,
                      0.5 * (delta_y - l_), 0.5 * (l_ - delta_y))
    on_highlight = jnp.abs(y_of_v - u_ * 0.5 * l_ / umax) < 0.5 * delta_y

    ok = in_range & on_highlight & (w_ * jnp.sin(umax) < l_) \
        & (kappa >= -1.0)
    return jnp.where(ok, fs / jnp.maximum(delta_y, 1e-20), 0.0)


def _staple_integrand(pat, u_, v_, om_i, om_r, psi, umax, kappa, w_, l_):
    """irawan.cpp evalStapleIntegrand (psi != 0 yarns)."""
    h = (om_i + om_r).normalized()
    su, cu = jnp.sin(u_), jnp.cos(u_)
    tan_psi = jnp.tan(jnp.where(psi == 0.0, 1.0, psi))  # guard for select
    D = (h.y * cu - h.z * su) / jnp.maximum(
        jnp.sqrt(h.x ** 2 + (h.y * su + h.z * cu) ** 2)
        * jnp.abs(tan_psi), 1e-20) * jnp.sign(tan_psi)
    Dc = jnp.clip(D, -1.0, 1.0)
    v_of_u = jnp.arctan2(-h.y * su - h.z * cu, h.x) + jnp.arccos(Dc)
    in_range = (jnp.abs(D) < 1.0) & (jnp.abs(v_of_u) < np.pi / 2.0)

    n = V3(jnp.sin(v_of_u), su * jnp.cos(v_of_u),
           cu * jnp.cos(v_of_u)).normalized()

    R = _radius_of_curvature(jnp.abs(u_), umax, kappa, w_, l_)
    a = 0.5 * w_
    s = om_i + om_r
    Gv = a * (R + a * jnp.cos(v_of_u)) / jnp.maximum(
        s.norm() * jnp.abs(n.dot(h)) * jnp.abs(jnp.sin(psi)), 1e-20)

    fc = pat.alpha + _von_mises(-om_i.dot(om_r), pat.beta)
    A = _seeliger(n.dot(om_i), n.dot(om_r))
    fs = Gv * fc * A * 2.0 * w_ * umax

    delta_x = w_ * pat.hWidth
    x_of_u = jnp.clip(v_of_u * w_ / np.pi,
                      0.5 * (delta_x - w_), 0.5 * (w_ - delta_x))
    on_highlight = jnp.abs(x_of_u - v_ * w_ / np.pi) < 0.5 * delta_x

    ok = in_range & on_highlight & (w_ * jnp.sin(umax) < l_) \
        & (kappa >= -1.0)
    return jnp.where(ok, fs / jnp.maximum(delta_x, 1e-20), 0.0)


def compute_normalization(pat: WeavePattern, n_samples: int = 10000,
                          seed: int = 0) -> WeavePattern:
    """MC-estimate the specular normalization (irawan.cpp configure():
    average the raw specular term under cosine-distributed wi/wo and
    uniform uv, then normalize so the average specular reflectance is at
    most 1/pi per unit ks)."""
    rng = np.random.default_rng(seed)
    us = rng.random((6, n_samples)).astype(np.float32)

    def cos_hemi(u1, u2):
        r = np.sqrt(u1)
        phi = 2.0 * np.pi * u2
        z = np.sqrt(np.maximum(1.0 - u1, 0.0))
        return (r * np.cos(phi), r * np.sin(phi), z)

    pat0 = dataclasses.replace(pat, normalization=1.0)

    def summed(uv_u, uv_v, wix, wiy, wiz, wox, woy, woz):
        return jnp.sum(eval_pattern(pat0, uv_u, uv_v, V3(wix, wiy, wiz),
                                    V3(wox, woy, woz),
                                    initialization=True))

    # one fused jit call on the host CPU: a scene-build-time constant, so
    # it neither dispatches op by op nor occupies the device
    wi = cos_hemi(us[0], us[1])
    wo = cos_hemi(us[2], us[3])
    with jax.default_device(jax.devices("cpu")[0]):
        total = float(jax.jit(summed)(us[4], us[5], *wi, *wo))
    if total <= 0.0:
        norm = 0.0
    else:
        norm = n_samples / (total * np.pi)
    return dataclasses.replace(pat, normalization=norm)
