"""Vector math over SoA arrays of shape ``(..., 3)``.

Capability parity with the reference math layer
(``/root/reference/include/mitsuba/core/{vector,normal,frame}.h``), expressed
as pure functions over batched arrays: every op vectorizes over leading batch
dimensions so the whole wavefront runs as one batch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .types import Float, EPSILON


def vec3(x, y, z) -> jax.Array:
    return jnp.stack(
        jnp.broadcast_arrays(
            jnp.asarray(x, Float), jnp.asarray(y, Float), jnp.asarray(z, Float)
        ),
        axis=-1,
    )


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b, axis=-1)


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    # manual components instead of jnp.cross's roll/slice lowering
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def squared_norm(a: jax.Array) -> jax.Array:
    return jnp.sum(a * a, axis=-1)


def norm(a: jax.Array) -> jax.Array:
    return jnp.sqrt(squared_norm(a))


def normalize(a: jax.Array) -> jax.Array:
    return a * jax.lax.rsqrt(jnp.maximum(squared_norm(a), 1e-30))[..., None]


def normalize_len(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Normalized vector and its original length."""
    l = norm(a)
    return a / jnp.maximum(l, 1e-30)[..., None], l


def lerp(a, b, t):
    return a + (b - a) * t


def safe_sqrt(x: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.maximum(x, 0.0))


def safe_acos(x: jax.Array) -> jax.Array:
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def safe_div(a: jax.Array, b: jax.Array, fallback=0.0) -> jax.Array:
    """a / b with 0 (or fallback) where b == 0 (no NaN under jit)."""
    b_safe = jnp.where(b == 0.0, 1.0, b)
    return jnp.where(b == 0.0, fallback, a / b_safe)


def coordinate_system(n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Build an orthonormal basis around unit vector ``n``.

    Branchless Duff et al. / Pixar variant (reference uses Hughes-Moeller in
    ``/root/reference/src/libcore/util.cpp`` ``coordinateSystem``); any valid
    frame works since BSDFs are isotropic in s/t unless tangents are supplied.
    """
    z = n[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    s = vec3(1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0])
    t = vec3(b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1])
    return s, t


class Frame:
    """Shading frame ops (reference ``include/mitsuba/core/frame.h``).

    Stateless: a frame is the tuple of arrays ``(s, t, n)``; local directions
    have n as the z-axis.
    """

    @staticmethod
    def from_normal(n: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
        s, t = coordinate_system(n)
        return s, t, n

    @staticmethod
    def to_local(frame, v: jax.Array) -> jax.Array:
        s, t, n = frame
        return jnp.stack([dot(v, s), dot(v, t), dot(v, n)], axis=-1)

    @staticmethod
    def to_world(frame, v: jax.Array) -> jax.Array:
        s, t, n = frame
        return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]

    # Trig helpers on local-frame directions (z = cos_theta).
    @staticmethod
    def cos_theta(v):
        return v[..., 2]

    @staticmethod
    def abs_cos_theta(v):
        return jnp.abs(v[..., 2])

    @staticmethod
    def cos_theta2(v):
        return v[..., 2] * v[..., 2]

    @staticmethod
    def sin_theta2(v):
        return jnp.maximum(0.0, 1.0 - v[..., 2] * v[..., 2])

    @staticmethod
    def sin_theta(v):
        return jnp.sqrt(Frame.sin_theta2(v))

    @staticmethod
    def tan_theta(v):
        return safe_div(Frame.sin_theta(v), v[..., 2])

    @staticmethod
    def tan_theta2(v):
        return safe_div(Frame.sin_theta2(v), Frame.cos_theta2(v), fallback=jnp.inf)

    @staticmethod
    def sin_phi(v):
        s = Frame.sin_theta(v)
        return jnp.where(s == 0.0, 0.0, jnp.clip(safe_div(v[..., 1], s), -1.0, 1.0))

    @staticmethod
    def cos_phi(v):
        s = Frame.sin_theta(v)
        return jnp.where(s == 0.0, 1.0, jnp.clip(safe_div(v[..., 0], s), -1.0, 1.0))


def reflect(wi: jax.Array) -> jax.Array:
    """Mirror reflection in the local frame (about +z)."""
    return vec3(-wi[..., 0], -wi[..., 1], wi[..., 2])


def reflect_n(wi: jax.Array, n: jax.Array) -> jax.Array:
    """Reflect ``wi`` about normal ``n`` (both pointing away from surface)."""
    return 2.0 * dot(wi, n)[..., None] * n - wi


def refract_n(wi: jax.Array, n: jax.Array, eta: jax.Array, cos_theta_t: jax.Array) -> jax.Array:
    """Refract ``wi`` about ``n`` given relative IOR and transmitted angle.

    ``eta`` here is etaI/etaT on the incident side; cos_theta_t signed like
    the reference (``util.cpp`` refract).
    """
    cos_theta_i = dot(wi, n)
    return n * (eta[..., None] * cos_theta_i[..., None] + cos_theta_t[..., None]) - wi * eta[..., None]


def spherical_direction(theta: jax.Array, phi: jax.Array) -> jax.Array:
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return vec3(st * cp, st * sp, ct)


def spherical_coordinates(d: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(theta, phi) with phi in [0, 2pi)."""
    theta = safe_acos(d[..., 2])
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
    return theta, phi


def face_forward(n: jax.Array, d: jax.Array) -> jax.Array:
    """Flip n to the hemisphere containing d."""
    return jnp.where(dot(n, d)[..., None] < 0.0, -n, n)
