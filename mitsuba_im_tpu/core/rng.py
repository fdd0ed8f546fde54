"""Counter-based per-lane RNG for wavefront rendering.

The reference uses a per-thread SFMT19937 stream cloned per core
(``/root/reference/include/mitsuba/core/random.h:88``,
``renderjob.cpp:57-68``).  The Wavefront design replaces stateful streams
with a *stateless counter-based hash*: every random draw is a pure function
of ``(seed, pixel_index, sample_index, dimension)``.  This gives

- bitwise determinism independent of device count and batch partitioning,
- exact path-replay for backprop (re-derive the same numbers, store nothing),
- trivial reimplementation inside a hand-written kernel (integer ops
  only).

Hash: PCG4D (Jarzynski & Olano, JCGT 2020) — public-domain 4-word mix used
widely in production GPU renderers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .types import pytree_dataclass, static_field

U32 = jnp.uint32


def pcg4d(v: jax.Array) -> jax.Array:
    """(..., 4) uint32 -> (..., 4) uint32 mixed output."""
    v = v.astype(U32)
    v = v * U32(1664525) + U32(1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def _to_unit_float(bits: jax.Array) -> jax.Array:
    """uint32 -> float32 in [0, 1) with 24-bit mantissa resolution."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def hash_u32(*words) -> jax.Array:
    """Mix up to 4 integer words into one uint32."""
    ws = [jnp.asarray(w).astype(U32) for w in words]
    while len(ws) < 4:
        ws.append(jnp.zeros_like(ws[0]))
    return pcg4d(jnp.stack(jnp.broadcast_arrays(*ws[:4]), axis=-1))[..., 0]


# Sampler kinds (static dispatch codes).
INDEPENDENT = 0
STRATIFIED = 1
LDSAMPLER = 2  # 0,2-sequence on dims 0-1, independent beyond
SOBOL = 3
HALTON = 4
HAMMERSLEY = 5


@pytree_dataclass
class SamplerState:
    """Per-lane sampler state flowing through the wavefront loop.

    Two-level scheme: ``base`` is a 4-word hash of (pixel, sample, seed)
    computed once at sampler creation; each draw re-hashes (base, dim).  This
    measurably decorrelates adjacent-dimension streams vs a single-level
    counter hash, at one PCG4D round per draw.

    ``table`` mode (MCMC): when ``table`` is a (..., B, 4) float array, block
    draws read ``table[..., dim // 4, :]`` instead of hashing — the sampler
    becomes a deterministic function of an explicit *primary sample vector*,
    which is what PSSMLT/ERPT mutate (the analog of the reference's
    ``PSSMLTSampler``, ``src/integrators/pssmlt/pssmlt_sampler.h``).  Draws
    past the table's end fall back to the hash (deterministic given
    (pixel, sample, seed), so the path remains a pure function of the state).
    """

    pixel: jax.Array  # (...,) uint32 flattened pixel index
    sample: jax.Array  # (...,) uint32 sample index within pixel
    base: jax.Array  # (..., 4) uint32 per-(pixel, sample, seed) state
    dim: jax.Array  # (...,) uint32 next dimension to consume
    seed: jax.Array  # () or (...,) uint32 global seed / scramble
    table: jax.Array | None = None  # (..., B, 4) explicit primary samples
    kind: int = static_field(default=INDEPENDENT)
    spp: int = static_field(default=1)

    def draw_bits(self, n_words: int) -> jax.Array:
        d = self.dim.astype(U32)
        ctr = jnp.stack(
            [
                self.base[..., 0],
                self.base[..., 1],
                self.base[..., 2] ^ d,
                self.base[..., 3],
            ],
            axis=-1,
        )
        return pcg4d(ctr)[..., :n_words]


def make_sampler(pixel, sample, seed, kind=INDEPENDENT, spp=1) -> SamplerState:
    pixel = jnp.asarray(pixel).astype(U32)
    sample = jnp.broadcast_to(jnp.asarray(sample).astype(U32), pixel.shape)
    seed = jnp.asarray(seed).astype(U32)
    base = pcg4d(
        jnp.stack(
            jnp.broadcast_arrays(
                pixel, sample, jnp.broadcast_to(seed, pixel.shape),
                jnp.full_like(pixel, U32(0x9E3779B9)),
            ),
            axis=-1,
        )
    )
    return SamplerState(
        pixel=pixel,
        sample=sample,
        base=base,
        dim=jnp.zeros_like(pixel),
        seed=seed,
        kind=kind,
        spp=spp,
    )


def _stratified_remap(s: SamplerState, u: jax.Array, dim0: jax.Array) -> jax.Array:
    """Jittered stratification of dims 0,1 over a near-square grid.

    Capability analog of the reference stratified/ldsampler image-plane
    stratification (``src/samplers/stratified.cpp``): sample i of spp lands
    in stratum i (x-major), jittered by the independent value.
    """
    import math

    res_x = int(math.isqrt(s.spp))
    res_x = max(res_x, 1)
    res_y = max(s.spp // res_x, 1)
    n = res_x * res_y
    idx = (s.sample % U32(n)).astype(jnp.float32)
    sx = jnp.mod(idx, float(res_x))
    sy = jnp.floor(idx / float(res_x))
    u0 = (sx + u[..., 0]) / res_x
    u1 = (sy + u[..., 1]) / res_y
    stratified = jnp.stack([u0, u1], axis=-1)
    return jnp.where((dim0 == 0)[..., None], stratified, u)


def _lds_pair(s: SamplerState, dim0: jax.Array) -> jax.Array:
    """Low-discrepancy 2D pair for the aligned dimension pair at ``dim0``.

    Padded Owen-scrambled Sobol' (Burley, JCGT 2020): every dimension pair
    reuses the (0,2) point set with an independent hash-based Owen scramble
    keyed by (pixel, seed, pair index).  Nested uniform scrambling preserves
    the (0,2)-net's elementary intervals, so per-pair stratification is
    exact while cross-pair correlation is broken — the stand-in
    for the reference's tabulated Joe-Kuo Sobol engine (sobolseq.h) that
    needs no data tables and no dynamic gathers.

    HALTON/HAMMERSLEY additionally use their true base-2/3 (resp. i/N)
    points on the image-plane pair (dim 0), where the dimension is static.
    """
    from . import qmc

    i = s.sample.astype(U32)
    pair = (dim0 >> 1).astype(U32)
    pix = s.pixel.astype(U32)
    sd = jnp.broadcast_to(jnp.asarray(s.seed, U32), pix.shape)
    scr = pcg4d(jnp.stack(
        jnp.broadcast_arrays(pix, sd, pair, jnp.full_like(pix, U32(77))),
        axis=-1))
    b0, b1 = qmc.sobol02_bits(i)
    u0 = qmc.bits_to_unit(qmc.owen_scramble(b0, scr[..., 0]))
    u1 = qmc.bits_to_unit(qmc.owen_scramble(b1, scr[..., 1]))

    if s.kind == HALTON:
        h0 = qmc.bits_to_unit(
            qmc.owen_scramble(qmc.radical_inverse_bits(i, 2), scr[..., 2]))
        h1 = qmc.bits_to_unit(
            qmc.owen_scramble(qmc.radical_inverse_bits(i, 3), scr[..., 3]))
        first = dim0 == 0
        u0 = jnp.where(first, h0, u0)
        u1 = jnp.where(first, h1, u1)
    elif s.kind == HAMMERSLEY:
        rot = _to_unit_float(scr[..., 2])
        h0 = jnp.mod(i.astype(jnp.float32) / jnp.float32(max(s.spp, 1)) + rot, 1.0)
        h1 = qmc.bits_to_unit(
            qmc.owen_scramble(qmc.radical_inverse_bits(i, 2), scr[..., 3]))
        first = dim0 == 0
        u0 = jnp.where(first, h0, u0)
        u1 = jnp.where(first, h1, u1)
    return jnp.stack([u0, u1], axis=-1)


def next_block4(s: SamplerState) -> tuple[SamplerState, jax.Array]:
    """Draw 4 dimensions with ONE hash (the hot-loop API).

    Aligns the dimension counter up to a multiple of 4 and returns all four
    words of a single PCG4D evaluation as (..., 4) floats.  Integrators that
    share a stream prefix (path vs direct) must consume the same block
    sequence for their estimates to match sample-for-sample.
    """
    dim = (s.dim + U32(3)) & ~U32(3)
    s2 = s.replace(dim=dim)
    bits = pcg4d(
        jnp.stack(
            [
                s.base[..., 0],
                s.base[..., 1],
                s.base[..., 2] ^ dim,
                s.base[..., 3],
            ],
            axis=-1,
        )
    )
    u = _to_unit_float(bits)
    if s.table is not None:
        blk = (dim >> 2).astype(jnp.int32)  # block index, lockstep per lane
        n_blocks = s.table.shape[-2]
        safe = jnp.minimum(blk, n_blocks - 1)
        tab = jnp.take_along_axis(
            s.table, safe[..., None, None], axis=-2
        )[..., 0, :]
        u = jnp.where((blk < n_blocks)[..., None], tab, u)
        return s2.replace(dim=dim + U32(4)), u
    if s.kind == STRATIFIED:
        u = u.at[..., :2].set(_stratified_remap(s2, u[..., :2], dim))
    elif s.kind in (LDSAMPLER, SOBOL, HALTON, HAMMERSLEY):
        lo = _lds_pair(s2, dim)
        hi = _lds_pair(s2, dim + U32(2))
        u = jnp.concatenate([lo, hi], axis=-1)
    return s2.replace(dim=dim + U32(4)), u


# ---------------------------------------------------------------------------
# Component-SoA sampler (canonical for the wavefront hot path): the 4-word
# state rides as four flat (N,) arrays so every hash op is a flat
# elementwise op.
# ---------------------------------------------------------------------------

def pcg4d_words(x, y, z, w):
    """PCG4D over four separate uint32 words (same mix as :func:`pcg4d`)."""
    x = x.astype(U32) * U32(1664525) + U32(1013904223)
    y = y.astype(U32) * U32(1664525) + U32(1013904223)
    z = z.astype(U32) * U32(1664525) + U32(1013904223)
    w = w.astype(U32) * U32(1664525) + U32(1013904223)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


@pytree_dataclass
class Sampler3:
    """SoA SamplerState; ``table`` carries the MCMC primary-sample vector
    exactly like SamplerState.table (PSSMLT/ERPT mutation target)."""

    pixel: jax.Array  # (N,) uint32
    sample: jax.Array  # (N,) uint32
    b0: jax.Array  # (N,) uint32 hashed base words
    b1: jax.Array
    b2: jax.Array
    b3: jax.Array
    dim: jax.Array  # (N,) uint32
    seed: jax.Array  # () or (N,) uint32
    table: jax.Array | None = None  # (N, B, 4) explicit primary samples
    kind: int = static_field(default=INDEPENDENT)
    spp: int = static_field(default=1)


def make_sampler_v(pixel, sample, seed, kind=INDEPENDENT, spp=1) -> Sampler3:
    pixel = jnp.asarray(pixel).astype(U32)
    sample = jnp.broadcast_to(jnp.asarray(sample).astype(U32), pixel.shape)
    seed = jnp.asarray(seed).astype(U32)
    b0, b1, b2, b3 = pcg4d_words(
        pixel, sample, jnp.broadcast_to(seed, pixel.shape),
        jnp.full_like(pixel, U32(0x9E3779B9)),
    )
    return Sampler3(
        pixel=pixel, sample=sample, b0=b0, b1=b1, b2=b2, b3=b3,
        dim=jnp.zeros_like(pixel), seed=seed, kind=kind, spp=spp,
    )


def _lds_pair_v(s: Sampler3, dim0):
    """SoA :func:`_lds_pair`: returns (u0, u1) flat arrays."""
    from . import qmc

    i = s.sample.astype(U32)
    pair = (dim0 >> 1).astype(U32)
    pix = s.pixel.astype(U32)
    sd = jnp.broadcast_to(jnp.asarray(s.seed, U32), pix.shape)
    s0, s1, s2, s3 = pcg4d_words(pix, sd, jnp.broadcast_to(pair, pix.shape),
                                 jnp.full_like(pix, U32(77)))
    b0, b1 = qmc.sobol02_bits(i)
    u0 = qmc.bits_to_unit(qmc.owen_scramble(b0, s0))
    u1 = qmc.bits_to_unit(qmc.owen_scramble(b1, s1))

    if s.kind == HALTON:
        h0 = qmc.bits_to_unit(
            qmc.owen_scramble(qmc.radical_inverse_bits(i, 2), s2))
        h1 = qmc.bits_to_unit(
            qmc.owen_scramble(qmc.radical_inverse_bits(i, 3), s3))
        first = dim0 == 0
        u0 = jnp.where(first, h0, u0)
        u1 = jnp.where(first, h1, u1)
    elif s.kind == HAMMERSLEY:
        rot = _to_unit_float(s2)
        h0 = jnp.mod(i.astype(jnp.float32) / jnp.float32(max(s.spp, 1)) + rot,
                     1.0)
        h1 = qmc.bits_to_unit(
            qmc.owen_scramble(qmc.radical_inverse_bits(i, 2), s3))
        first = dim0 == 0
        u0 = jnp.where(first, h0, u0)
        u1 = jnp.where(first, h1, u1)
    return u0, u1


def next_block4_v(s: Sampler3):
    """Draw 4 dimensions with ONE word-wise hash; returns
    (sampler, (u0, u1, u2, u3)) of flat arrays."""
    dim = (s.dim + U32(3)) & ~U32(3)
    s2 = s.replace(dim=dim + U32(4))
    x, y, z, w = pcg4d_words(s.b0, s.b1, s.b2 ^ dim, s.b3)
    u0, u1, u2, u3 = (_to_unit_float(t) for t in (x, y, z, w))
    if s.table is not None:
        blk = (dim >> 2).astype(jnp.int32)  # block index, lockstep per lane
        n_blocks = s.table.shape[-2]
        safe = jnp.minimum(blk, n_blocks - 1)
        tab = jnp.take_along_axis(
            s.table, safe[..., None, None], axis=-2)[..., 0, :]
        ok = blk < n_blocks
        u0 = jnp.where(ok, tab[..., 0], u0)
        u1 = jnp.where(ok, tab[..., 1], u1)
        u2 = jnp.where(ok, tab[..., 2], u2)
        u3 = jnp.where(ok, tab[..., 3], u3)
        return s2, (u0, u1, u2, u3)
    if s.kind == STRATIFIED:
        import math

        res_x = max(int(math.isqrt(s.spp)), 1)
        res_y = max(s.spp // res_x, 1)
        n = res_x * res_y
        idx = (s.sample % U32(n)).astype(jnp.float32)
        sx = jnp.mod(idx, float(res_x))
        sy = jnp.floor(idx / float(res_x))
        first = dim == 0
        u0 = jnp.where(first, (sx + u0) / res_x, u0)
        u1 = jnp.where(first, (sy + u1) / res_y, u1)
    elif s.kind in (LDSAMPLER, SOBOL, HALTON, HAMMERSLEY):
        u0, u1 = _lds_pair_v(s, dim)
        u2, u3 = _lds_pair_v(s, dim + U32(2))
    return s2, (u0, u1, u2, u3)


def next_1d(s: SamplerState) -> tuple[SamplerState, jax.Array]:
    u = _to_unit_float(s.draw_bits(1)[..., 0])
    return s.replace(dim=s.dim + U32(1)), u


def next_2d(s: SamplerState) -> tuple[SamplerState, jax.Array]:
    bits = s.draw_bits(2)
    u = _to_unit_float(bits)
    if s.kind == STRATIFIED:
        u = _stratified_remap(s, u, s.dim)
    elif s.kind in (LDSAMPLER, SOBOL, HALTON, HAMMERSLEY):
        u = _lds_pair(s, s.dim)
    return s.replace(dim=s.dim + U32(2)), u
