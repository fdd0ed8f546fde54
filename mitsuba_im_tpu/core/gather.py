"""Row lookup from small tables.

For the renderer's small entity tables (BSDFs, emitters, shapes) a lookup
is a fused select-chain, and bundling all columns of a table into one
matrix amortizes one lookup across every attribute.  Large tables (BVH
nodes, texture atlas) keep native gathers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

SELECT_MAX = 64


def gather_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """table (T,) or (T, C); idx (...,) int -> (...,) or (..., C).

    idx values must be in [0, T); callers clamp beforehand.
    """
    squeeze = table.ndim == 1
    tab = table[:, None] if squeeze else table
    T = tab.shape[0]
    if T == 1:
        out = jnp.broadcast_to(tab[0], idx.shape + (tab.shape[1],))
    elif T <= SELECT_MAX:
        out = jnp.broadcast_to(tab[0], idx.shape + (tab.shape[1],))
        for k in range(1, T):
            out = jnp.where((idx == k)[..., None], tab[k], out)
    else:
        out = tab[idx]
    return out[..., 0] if squeeze else out


class RowBundle:
    """Pack scalar/vector columns into one matrix, look up once, unpack.

    Usage::
        b = RowBundle()
        b.add("refl", table.refl)          # (T, 3)
        b.add("eta_s", table.eta_s)        # (T,)
        rows = b.lookup(idx)               # one gather/select chain
        refl = rows["refl"]; eta = rows["eta_s"]

    Integer columns ride as f32 (exact below 2^24) and are cast back.
    """

    def __init__(self):
        self._cols: list[tuple[str, int, object]] = []  # (name, width, dtype)
        self._parts: list[jax.Array] = []

    def add(self, name: str, col: jax.Array):
        c = col[:, None] if col.ndim == 1 else col
        self._cols.append((name, c.shape[1], col.dtype))
        self._parts.append(c.astype(jnp.float32))
        return self

    def lookup(self, idx: jax.Array) -> dict:
        mat = jnp.concatenate(self._parts, axis=1)
        rows = gather_rows(mat, idx)
        out = {}
        off = 0
        for name, w, dt in self._cols:
            v = rows[..., off : off + w]
            if jnp.issubdtype(dt, jnp.integer) or dt == jnp.bool_:
                v = jnp.round(v).astype(dt)
            elif v.dtype != dt:
                v = v.astype(dt)
            if w == 1:
                v = v[..., 0]
            out[name] = v
            off += w
        return out
