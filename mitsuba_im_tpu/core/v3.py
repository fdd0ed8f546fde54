"""Component-SoA 3-vectors: the layout of the wavefront math.

Why this exists: with an ``(N, 3)`` array every dot product is a reduce
over a trailing axis of 3 and every component access a strided slice.
Storing each component as a flat ``(N,)`` array turns every vector op into
fused full-width elementwise work: a dot is three multiplies and two adds,
no reduce.  This module is the canonical math layer for the hot
path; ``core.math`` keeps the ``(..., 3)`` API as a compatibility wrapper
for not-yet-migrated callers.

Replaces the reference's TVector3/TPoint3/Frame value types
(``/root/reference/include/mitsuba/core/{vector,point,normal,frame}.h``)
for the wavefront compute path.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .types import Float


class V3(NamedTuple):
    """A batch of 3-vectors stored as three flat component arrays.

    Also used for RGB spectra (x=r, y=g, z=b) — the reference's
    ``Spectrum`` with SPECTRUM_SAMPLES=3 (spectrum.h:25-28).
    Being a NamedTuple it is automatically a JAX pytree.
    """

    x: jax.Array
    y: jax.Array
    z: jax.Array

    # -- construction ------------------------------------------------------
    @staticmethod
    def of(x, y, z) -> "V3":
        x, y, z = (jnp.asarray(v, Float) for v in (x, y, z))
        x, y, z = jnp.broadcast_arrays(x, y, z)
        return V3(x, y, z)

    @staticmethod
    def full(shape, value=0.0) -> "V3":
        a = jnp.full(shape, value, Float)
        return V3(a, a, a)

    @staticmethod
    def from_array(a: jax.Array) -> "V3":
        """(..., 3) -> V3 of (...,) components (cheap compact-array slices)."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def from_scalar(s) -> "V3":
        s = jnp.asarray(s, Float)
        return V3(s, s, s)

    def to_array(self) -> jax.Array:
        """V3 -> (..., 3).  A real relayout; keep off the hot path."""
        return jnp.stack(jnp.broadcast_arrays(*self), axis=-1)

    # -- arithmetic (component-wise; scalars broadcast) --------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- reductions --------------------------------------------------------
    def dot(self, o: "V3") -> jax.Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def sum(self) -> jax.Array:
        return self.x + self.y + self.z

    def mean(self) -> jax.Array:
        return (self.x + self.y + self.z) * (1.0 / 3.0)

    def max_c(self) -> jax.Array:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def min_c(self) -> jax.Array:
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    def squared_norm(self) -> jax.Array:
        return self.dot(self)

    def norm(self) -> jax.Array:
        return jnp.sqrt(self.squared_norm())

    # -- vector ops ---------------------------------------------------------
    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def normalized(self) -> "V3":
        inv = jax.lax.rsqrt(jnp.maximum(self.squared_norm(), 1e-30))
        return self * inv

    def normalized_len(self) -> tuple["V3", jax.Array]:
        l = self.norm()
        return self * (1.0 / jnp.maximum(l, 1e-30)), l

    # -- elementwise helpers -------------------------------------------------
    def abs(self) -> "V3":
        return V3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    def maximum(self, o) -> "V3":
        if isinstance(o, V3):
            return V3(jnp.maximum(self.x, o.x), jnp.maximum(self.y, o.y),
                      jnp.maximum(self.z, o.z))
        return V3(jnp.maximum(self.x, o), jnp.maximum(self.y, o),
                  jnp.maximum(self.z, o))

    def exp(self) -> "V3":
        return V3(jnp.exp(self.x), jnp.exp(self.y), jnp.exp(self.z))

    def broadcast_to(self, shape) -> "V3":
        return V3(*(jnp.broadcast_to(c, shape) for c in self))

    @property
    def shape(self):
        return jnp.broadcast_shapes(self.x.shape, self.y.shape, self.z.shape)

    @property
    def dtype(self):
        return self.x.dtype


def where(mask: jax.Array, a: V3, b: V3) -> V3:
    return V3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
              jnp.where(mask, a.z, b.z))


def zeros(shape) -> V3:
    z = jnp.zeros(shape, Float)
    return V3(z, z, z)


def ones(shape) -> V3:
    o = jnp.ones(shape, Float)
    return V3(o, o, o)


def lerp(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


# ---------------------------------------------------------------------------
# Frames (reference include/mitsuba/core/frame.h) — a frame is (s, t, n)
# ---------------------------------------------------------------------------

def coordinate_system(n: V3) -> tuple[V3, V3]:
    """Branchless Duff et al. orthonormal basis around unit ``n``."""
    sign = jnp.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    s = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    t = V3(b, sign + n.y * n.y * a, -n.y)
    return s, t


def frame_from_normal(n: V3) -> tuple[V3, V3, V3]:
    s, t = coordinate_system(n)
    return s, t, n


def to_local(frame: tuple[V3, V3, V3], v: V3) -> V3:
    s, t, n = frame
    return V3(v.dot(s), v.dot(t), v.dot(n))


def to_world(frame: tuple[V3, V3, V3], v: V3) -> V3:
    s, t, n = frame
    return s * v.x + t * v.y + n * v.z


# Local-frame trig (z = cos_theta); mirrors core.math.Frame
def sin_theta2(v: V3) -> jax.Array:
    return jnp.maximum(0.0, 1.0 - v.z * v.z)


def sin_theta(v: V3) -> jax.Array:
    return jnp.sqrt(sin_theta2(v))


def tan_theta(v: V3) -> jax.Array:
    return safe_div(sin_theta(v), v.z)


def tan_theta2(v: V3) -> jax.Array:
    return safe_div(sin_theta2(v), v.z * v.z, fallback=jnp.inf)


def sin_phi(v: V3) -> jax.Array:
    s = sin_theta(v)
    return jnp.where(s == 0.0, 0.0, jnp.clip(safe_div(v.y, s), -1.0, 1.0))


def cos_phi(v: V3) -> jax.Array:
    s = sin_theta(v)
    return jnp.where(s == 0.0, 1.0, jnp.clip(safe_div(v.x, s), -1.0, 1.0))


def safe_div(a, b, fallback=0.0):
    b_safe = jnp.where(b == 0.0, 1.0, b)
    return jnp.where(b == 0.0, fallback, a / b_safe)


def reflect(wi: V3) -> V3:
    """Mirror reflection about local +z."""
    return V3(-wi.x, -wi.y, wi.z)


def reflect_n(wi: V3, n: V3) -> V3:
    return n * (2.0 * wi.dot(n)) - wi


def refract_n(wi: V3, n: V3, eta: jax.Array, cos_theta_t: jax.Array) -> V3:
    cos_theta_i = wi.dot(n)
    return n * (eta * cos_theta_i + cos_theta_t) - wi * eta


def face_forward(n: V3, d: V3) -> V3:
    flip = n.dot(d) < 0.0
    return where(flip, -n, n)


def spherical_direction(theta: jax.Array, phi: jax.Array) -> V3:
    st, ct = jnp.sin(theta), jnp.cos(theta)
    return V3(st * jnp.cos(phi), st * jnp.sin(phi), ct)


def spherical_coordinates(d: V3) -> tuple[jax.Array, jax.Array]:
    theta = jnp.arccos(jnp.clip(d.z, -1.0, 1.0))
    phi = jnp.arctan2(d.y, d.x)
    phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
    return theta, phi


# ---------------------------------------------------------------------------
# Sampling warps in SoA (canonical versions of core.warp)
# ---------------------------------------------------------------------------

def square_to_uniform_disk_concentric(u1: jax.Array, u2: jax.Array):
    """Shirley-Chiu concentric disk mapping (reference ``warp.cpp``)."""
    r1 = 2.0 * u1 - 1.0
    r2 = 2.0 * u2 - 1.0
    zero = (r1 == 0.0) & (r2 == 0.0)
    use_r1 = jnp.abs(r1) > jnp.abs(r2)
    r = jnp.where(use_r1, r1, r2)
    safe = jnp.where(r == 0.0, 1.0, r)
    phi = jnp.where(
        use_r1,
        (jnp.pi / 4.0) * (r2 / safe),
        (jnp.pi / 2.0) - (r1 / safe) * (jnp.pi / 4.0),
    )
    r = jnp.where(zero, 0.0, r)
    phi = jnp.where(zero, 0.0, phi)
    return r * jnp.cos(phi), r * jnp.sin(phi)


def square_to_cosine_hemisphere(u1: jax.Array, u2: jax.Array) -> V3:
    """Concentric-disk lift (matches ``core.warp`` bit-for-bit so AoS and
    SoA integrators trace identical paths from identical uniforms)."""
    px, py = square_to_uniform_disk_concentric(u1, u2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - px * px - py * py))
    return V3(px, py, z)


def square_to_cosine_hemisphere_pdf(d: V3) -> jax.Array:
    return jnp.maximum(d.z, 0.0) * (1.0 / jnp.pi)


def square_to_uniform_sphere(u1: jax.Array, u2: jax.Array) -> V3:
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u2
    return V3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def square_to_uniform_triangle(u1: jax.Array, u2: jax.Array):
    a = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    return 1.0 - a, a * u2


# ---------------------------------------------------------------------------
# Table gathers in SoA: per-column select chains over small tables
# ---------------------------------------------------------------------------

SELECT_MAX = 64


def gather_col(col: jax.Array, idx: jax.Array) -> jax.Array:
    """Look up ``col[idx]`` where ``col`` is a small (T,) table.

    Lowered as a fused full-density select chain (XLA folds the scalar
    table entries into the fusion); large tables fall back to a native
    gather.  idx must be pre-clamped to [0, T).
    """
    T = col.shape[0]
    if T == 1:
        return jnp.broadcast_to(col[0], idx.shape)
    if T > SELECT_MAX:
        return col[idx]
    out = jnp.broadcast_to(col[0], idx.shape)
    for k in range(1, T):
        out = jnp.where(idx == k, col[k], out)
    return out


def gather_v3(tab: jax.Array, idx: jax.Array) -> V3:
    """Row lookup of a small (T, 3) table as a V3 of full-density columns."""
    return V3(gather_col(tab[:, 0], idx), gather_col(tab[:, 1], idx),
              gather_col(tab[:, 2], idx))
