"""Discrete 1D/2D distributions for importance sampling.

Reference: ``/root/reference/include/mitsuba/core/pmf.h:35``
(DiscreteDistribution) and the hierarchical 2D CDF inside the envmap emitter
(``/root/reference/src/emitters/envmap.cpp``).

Redesign note: per-lane CDF binary search is a ~20-iteration
gather-in-a-while-loop over the wavefront.
``Distribution2D`` therefore carries Walker/Vose **alias tables** (built in
native C++ at scene build, exact per-cell probabilities) and samples in
O(1): two gathers and a compare per level, with sample reuse for the
in-texel offsets.  The CDF path remains as fallback for callers without
the native lib.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .types import Float, Int, pytree_dataclass


def _build_alias_rows(w: np.ndarray):
    """(H, W) weights -> (prob, alias) alias tables per row; native C++
    fast path, numpy/python fallback (same Vose algorithm)."""
    from ..accel.native import build_alias_rows_native

    out = build_alias_rows_native(w)
    if out is not None:
        return out
    H, W = w.shape
    prob = np.ones((H, W), np.float32)
    alias = np.tile(np.arange(W, dtype=np.int32), (H, 1))
    for r in range(H):
        ww = np.maximum(w[r].astype(np.float64), 0.0)
        total = ww.sum()
        scaled = ww * W / total if total > 0 else np.ones(W)
        small = [i for i in range(W) if scaled[i] < 1.0]
        large = [i for i in range(W) if scaled[i] >= 1.0]
        while small and large:
            s = small.pop()
            l = large.pop()
            prob[r, s] = scaled[s]
            alias[r, s] = l
            scaled[l] = (scaled[l] + scaled[s]) - 1.0
            (small if scaled[l] < 1.0 else large).append(l)
    return prob, alias


@pytree_dataclass
class Distribution1D:
    """Normalized CDF table over N entries.

    ``cdf`` has N+1 entries, cdf[0] = 0, cdf[N] = 1.  ``pmf`` is the
    normalized probability per entry; ``integral`` the pre-normalization sum.
    """

    pmf: jax.Array  # (N,)
    cdf: jax.Array  # (N+1,)
    integral: jax.Array  # ()

    @staticmethod
    def from_weights(w) -> "Distribution1D":
        w = jnp.asarray(w, Float)
        total = jnp.sum(w)
        safe = jnp.where(total > 0, total, 1.0)
        pmf = jnp.where(total > 0, w / safe, jnp.ones_like(w) / w.shape[0])
        cdf = jnp.concatenate([jnp.zeros((1,), Float), jnp.cumsum(pmf)])
        # Force exact closure so sample() never falls off the end.
        cdf = cdf.at[-1].set(1.0)
        return Distribution1D(pmf=pmf, cdf=cdf, integral=total)

    def sample(self, u: jax.Array) -> tuple[jax.Array, jax.Array]:
        """Sample entry index; returns (index, pmf[index])."""
        n = self.pmf.shape[0]
        if n <= 64:
            # compare-sum: no per-lane binary search over tiny tables
            idx = jnp.clip(
                jnp.sum(self.cdf[1:-1][None] <= u[..., None], axis=-1), 0, n - 1
            ).astype(jnp.int32)
            from .gather import gather_rows

            return idx, gather_rows(self.pmf, idx)
        idx = jnp.clip(
            jnp.searchsorted(self.cdf, u, side="right") - 1, 0, n - 1
        )
        return idx, self.pmf[idx]

    def sample_reuse(self, u: jax.Array):
        """Sample and rescale u for reuse (reference pmf.h sampleReuse)."""
        idx, p = self.sample(u)
        lo = self.cdf[idx]
        u2 = jnp.where(p > 0, (u - lo) / jnp.maximum(p, 1e-20), 0.0)
        return idx, p, jnp.clip(u2, 0.0, 1.0)


@pytree_dataclass
class Distribution2D:
    """Row-major 2D sampling table (for envmap importance sampling).

    Sample v from the marginal over rows, then u from the conditional within
    the row.  Continuous variant returns (u, v) in [0,1)^2 plus the density
    w.r.t. the unit square.
    """

    cond_cdf: jax.Array  # (H, W+1) conditional CDFs per row
    cond_pmf: jax.Array  # (H, W)
    marg_cdf: jax.Array  # (H+1,)
    marg_pmf: jax.Array  # (H,)
    # O(1) alias-table sampling path (None -> CDF binary-search fallback)
    marg_aprob: jax.Array = None  # (H,)
    marg_alias: jax.Array = None  # (H,) int32
    cond_aprob: jax.Array = None  # (H, W)
    cond_alias: jax.Array = None  # (H, W) int32

    @staticmethod
    def from_weights(w) -> "Distribution2D":
        w = jnp.asarray(w, Float)
        H, W = w.shape
        row_sum = jnp.sum(w, axis=1)
        safe_rows = jnp.where(row_sum > 0, row_sum, 1.0)[:, None]
        cond_pmf = jnp.where(row_sum[:, None] > 0, w / safe_rows, 1.0 / W)
        cond_cdf = jnp.concatenate(
            [jnp.zeros((H, 1), Float), jnp.cumsum(cond_pmf, axis=1)], axis=1
        )
        cond_cdf = cond_cdf.at[:, -1].set(1.0)
        total = jnp.sum(row_sum)
        safe_total = jnp.where(total > 0, total, 1.0)
        marg_pmf = jnp.where(total > 0, row_sum / safe_total, 1.0 / H)
        marg_cdf = jnp.concatenate([jnp.zeros((1,), Float), jnp.cumsum(marg_pmf)])
        marg_cdf = marg_cdf.at[-1].set(1.0)
        # alias tables (host build; from_weights runs at scene-build time)
        wn = np.asarray(w, np.float32)
        mprob, malias = _build_alias_rows(np.asarray(
            jnp.where(total > 0, row_sum, 1.0), np.float32)[None, :])
        cprob, calias = _build_alias_rows(wn)
        return Distribution2D(
            cond_cdf=cond_cdf, cond_pmf=cond_pmf, marg_cdf=marg_cdf,
            marg_pmf=marg_pmf,
            marg_aprob=jnp.asarray(mprob[0], Float),
            marg_alias=jnp.asarray(malias[0], Int),
            cond_aprob=jnp.asarray(cprob, Float),
            cond_alias=jnp.asarray(calias, Int),
        )

    @property
    def shape(self):
        return self.cond_pmf.shape

    def sample_continuous(self, s: jax.Array):
        """s: (..., 2) -> ((..., 2) uv in [0,1)^2, pdf wrt unit square)."""
        if self.marg_aprob is not None:
            return self._sample_alias(s)
        return self._sample_cdf(s)

    def _sample_alias(self, s: jax.Array):
        """O(1) two-level alias sampling: u2 picks the row (marginal), u1
        the column (conditional); both uniforms are reused for the in-texel
        offsets via the standard conditional rescale."""
        H, W = self.cond_pmf.shape
        u1, u2 = s[..., 0], s[..., 1]
        x2 = jnp.clip(u2, 0.0, 1.0 - 1e-7) * H
        j2 = jnp.clip(x2.astype(Int), 0, H - 1)
        f2 = x2 - j2.astype(Float)
        pj = self.marg_aprob[j2]
        keep2 = f2 < pj
        row = jnp.where(keep2, j2, self.marg_alias[j2])
        dv = jnp.where(keep2, f2 / jnp.maximum(pj, 1e-20),
                       (f2 - pj) / jnp.maximum(1.0 - pj, 1e-20))
        # clamp strictly inside the texel: an offset that rounds to 1.0
        # would land in the NEIGHBORING texel, making the reported pdf
        # disagree with pdf_continuous at the returned uv
        v = (row.astype(Float) + jnp.clip(dv, 0.0, 0.9995)) / H

        x1 = jnp.clip(u1, 0.0, 1.0 - 1e-7) * W
        j1 = jnp.clip(x1.astype(Int), 0, W - 1)
        f1 = x1 - j1.astype(Float)
        flat1 = row * W + j1
        pc = self.cond_aprob.reshape(-1)[flat1]
        keep1 = f1 < pc
        col = jnp.where(keep1, j1, self.cond_alias.reshape(-1)[flat1])
        du = jnp.where(keep1, f1 / jnp.maximum(pc, 1e-20),
                       (f1 - pc) / jnp.maximum(1.0 - pc, 1e-20))
        u = (col.astype(Float) + jnp.clip(du, 0.0, 0.9995)) / W
        pdf = (self.marg_pmf[row] * H
               * self.cond_pmf.reshape(-1)[row * W + col] * W)
        return jnp.stack([u, v], axis=-1), pdf

    def _sample_cdf(self, s: jax.Array):
        H, W = self.cond_pmf.shape
        u1, u2 = s[..., 0], s[..., 1]
        row = jnp.clip(jnp.searchsorted(self.marg_cdf, u2, side="right") - 1, 0, H - 1)
        mpmf = self.marg_pmf[row]
        dv = jnp.where(mpmf > 0, (u2 - self.marg_cdf[row]) / jnp.maximum(mpmf, 1e-20), 0.5)
        v = (row.astype(Float) + jnp.clip(dv, 0.0, 1.0)) / H

        ccdf = self.cond_cdf[row]  # (..., W+1) gather rows
        col = jnp.clip(
            jax.vmap(lambda c, x: jnp.searchsorted(c, x, side="right"))(
                ccdf.reshape(-1, W + 1), u1.reshape(-1)
            ).reshape(u1.shape)
            - 1,
            0,
            W - 1,
        )
        cpmf = self.cond_pmf[row, col]
        du = jnp.where(cpmf > 0, (u1 - self.cond_cdf[row, col]) / jnp.maximum(cpmf, 1e-20), 0.5)
        u = (col.astype(Float) + jnp.clip(du, 0.0, 1.0)) / W
        pdf = mpmf * H * cpmf * W
        return jnp.stack([u, v], axis=-1), pdf

    def pdf_continuous(self, uv: jax.Array) -> jax.Array:
        H, W = self.cond_pmf.shape
        col = jnp.clip((uv[..., 0] * W).astype(jnp.int32), 0, W - 1)
        row = jnp.clip((uv[..., 1] * H).astype(jnp.int32), 0, H - 1)
        return self.marg_pmf[row] * H * self.cond_pmf[row, col] * W
