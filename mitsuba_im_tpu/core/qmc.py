"""Quasi-Monte-Carlo point sets: Sobol' + Halton/Hammersley.

Capability analog of the reference's QMC layer
(``/root/reference/include/mitsuba/core/qmc.h`` radical inverses,
``src/samplers/sobolseq.h`` Sobol sequence engine, ``halton.cpp`` /
``hammersley.cpp`` / ``sobol.cpp`` plugins).  The reference ships 108k LoC
of tabulated Joe-Kuo direction numbers; this build *generates* direction
numbers at import time from brute-forced primitive polynomials over GF(2)
(seconds of host work, zero data tables) and regains sample quality through
hash-based Owen scrambling (Burley, "Practical Hash-based Owen Scrambling",
JCGT 2020), which decorrelates dimension pairs far better than unscrambled
table choice does.

Everything device-side is uint32 bit math with static loop unrolls (no
gathers, no dynamic shapes).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

U32 = jnp.uint32

MAX_SOBOL_DIMS = 64
MAX_INDEX_BITS = 24  # sample indices < 2^24 (spp per pixel never near this)

_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139,
    149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223,
    227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293,
    307, 311,
]


# ---------------------------------------------------------------------------
# Sobol' direction numbers (host-side, generated once at import)
# ---------------------------------------------------------------------------

def _gf2_mulmod(a: int, b: int, poly: int, deg: int) -> int:
    """(a*b) mod poly over GF(2)[x]."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> deg & 1:
            a ^= poly
    return r


def _is_primitive(poly: int, deg: int) -> bool:
    """x generates GF(2^deg)* modulo poly (poly irreducible + full order)."""
    order = (1 << deg) - 1

    def powx(e: int) -> int:
        result, base = 1, 2  # polynomial 'x'
        while e:
            if e & 1:
                result = _gf2_mulmod(result, base, poly, deg)
            base = _gf2_mulmod(base, base, poly, deg)
            e >>= 1
        return result

    if powx(order) != 1:
        return False
    # check proper divisors via prime factors of the order
    n, fac = order, []
    p = 2
    while p * p <= n:
        if n % p == 0:
            fac.append(p)
            while n % p == 0:
                n //= p
        p += 1
    if n > 1:
        fac.append(n)
    return all(powx(order // q) != 1 for q in fac)


def _primitive_polys(count: int) -> list[tuple[int, int]]:
    """First ``count`` primitive polynomials (poly bitmask, degree),
    ordered by degree then lexicographically — the conventional Sobol'
    dimension assignment."""
    out: list[tuple[int, int]] = []
    deg = 1
    while len(out) < count:
        for low in range(1 << (deg - 1), 1 << deg) if deg > 1 else [1]:
            poly = (1 << deg) | low
            if poly & 1 and _is_primitive(poly, deg):
                out.append((poly, deg))
                if len(out) >= count:
                    break
        deg += 1
    return out


def _direction_numbers(n_dims: int, n_bits: int = 32) -> np.ndarray:
    """(n_dims, n_bits) uint32 direction-number matrix V.

    Dim 0 is van der Corput (identity).  Initial m-values: the handful of
    low-dim Joe-Kuo optima that are common knowledge, then deterministic
    odd values (Owen scrambling downstream restores projection quality).
    """
    V = np.zeros((n_dims, n_bits), np.uint32)
    V[0] = np.uint32(1) << (31 - np.arange(n_bits, dtype=np.uint32))

    polys = _primitive_polys(n_dims - 1)
    known_m = {0: [1], 1: [1, 3], 2: [1, 3, 1], 3: [1, 1, 1]}
    rng = np.random.default_rng(0x5A17)
    for j, (poly, s) in enumerate(polys):
        a = [(poly >> (s - 1 - k)) & 1 for k in range(1, s)]  # inner coeffs
        m = list(known_m.get(j, []))
        if len(m) != s:
            m = [int(2 * rng.integers(0, 1 << max(k, 0)) + 1) & ((1 << (k + 1)) - 1)
                 for k in range(s)]
            m = [mm | 1 for mm in m]
        for k in range(s, n_bits):
            new = m[k - s] ^ (m[k - s] << s)
            for t in range(1, s):
                if a[t - 1]:
                    new ^= m[k - t] << t
            m.append(new)
        for k in range(n_bits):
            V[j + 1, k] = np.uint32(m[k] << (31 - k))
    return V


_SOBOL_V = _direction_numbers(MAX_SOBOL_DIMS)


# ---------------------------------------------------------------------------
# Device-side point evaluation
# ---------------------------------------------------------------------------

def _reverse_bits(x: jax.Array) -> jax.Array:
    x = ((x & U32(0x55555555)) << 1) | ((x & U32(0xAAAAAAAA)) >> 1)
    x = ((x & U32(0x33333333)) << 2) | ((x & U32(0xCCCCCCCC)) >> 2)
    x = ((x & U32(0x0F0F0F0F)) << 4) | ((x & U32(0xF0F0F0F0)) >> 4)
    x = ((x & U32(0x00FF00FF)) << 8) | ((x & U32(0xFF00FF00)) >> 8)
    return (x << 16) | (x >> 16)


def owen_scramble(x: jax.Array, seed: jax.Array) -> jax.Array:
    """Hash-based nested uniform (Owen) scramble of a radical-inverse value
    whose fraction is MSB-first in a uint32 (Burley 2020, Laine-Karras
    permutation in reversed-bit space)."""
    x = _reverse_bits(x.astype(U32))
    s = seed.astype(U32)
    x = x + s
    x = x ^ (x * U32(0x6C50B47C))
    x = x ^ (x * U32(0xB82F1E52))
    x = x ^ (x * U32(0xC7AFE638))
    x = x ^ (x * U32(0x8D22F6E6))
    return _reverse_bits(x)


def sobol_bits(index: jax.Array, dim: int) -> jax.Array:
    """Unscrambled Sobol' sample ``index`` of dimension ``dim`` as a
    MSB-first uint32 fraction.  Static unroll over MAX_INDEX_BITS."""
    i = index.astype(U32)
    x = jnp.zeros_like(i)
    for k in range(MAX_INDEX_BITS):
        v = U32(int(_SOBOL_V[dim, k]))
        x = jnp.where((i >> k) & U32(1) != 0, x ^ v, x)
    return x


def radical_inverse_bits(index: jax.Array, base: int) -> jax.Array:
    """Radical inverse in ``base`` as a MSB-first uint32 fraction.

    Digit count is static per base (enough for MAX_INDEX_BITS-bit indices);
    digits are mapped to a binary fraction by fixed-point accumulation.
    """
    if base == 2:
        return _reverse_bits(index.astype(U32))
    n_digits = int(np.ceil(MAX_INDEX_BITS / np.log2(base)))
    i = index.astype(U32)
    inv = jnp.zeros(index.shape, jnp.float32)
    f = jnp.float32(1.0 / base)
    for _ in range(n_digits):
        d = (i % U32(base)).astype(jnp.float32)
        i = i // U32(base)
        inv = inv + d * f
        f = f * jnp.float32(1.0 / base)
    # to MSB-first fixed point for the scrambler
    inv = jnp.minimum(inv, 0.99999994)
    return (inv * jnp.float32(4294967296.0)).astype(U32)


def bits_to_unit(x: jax.Array) -> jax.Array:
    return (x >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def sobol02_bits(index: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Dims 0,1 of the Sobol' sequence as MSB-first uint32 fractions
    (van der Corput + the x^2+x+1 recurrence), static unroll."""
    i = index.astype(U32)
    b0 = _reverse_bits(i)
    x = jnp.zeros_like(i)
    c = U32(1 << 31)
    ii = i
    for _ in range(MAX_INDEX_BITS):
        x = jnp.where((ii & U32(1)) != 0, x ^ c, x)
        c = c ^ (c >> 1)
        ii = ii >> 1
    return b0, x


def sobol_owen(index: jax.Array, dim: int, seed: jax.Array) -> jax.Array:
    """Owen-scrambled Sobol' value in [0,1)."""
    return bits_to_unit(owen_scramble(sobol_bits(index, dim), seed))


def halton_scrambled(index: jax.Array, dim: int, seed: jax.Array) -> jax.Array:
    """Owen-scrambled Halton value in [0,1) (dimension -> prime base)."""
    base = _PRIMES[dim % len(_PRIMES)]
    return bits_to_unit(owen_scramble(radical_inverse_bits(index, base), seed))
