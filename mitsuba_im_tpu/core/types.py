"""Core typing substrate: pytree dataclasses, constants, dtype policy.

The reference renderer builds everything on a refcounted ``Object`` model with
RTTI (``/root/reference/include/mitsuba/core/object.h:38``,
``class.h:43``).  The JAX analog is *data, not objects*: every
renderer entity is an immutable pytree dataclass of device arrays plus static
(hashable) configuration, so the whole scene can flow through ``jax.jit`` /
``pjit`` and be sharded with ``jax.sharding``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax
import jax.numpy as jnp
import numpy as np

T = TypeVar("T")

# ---------------------------------------------------------------------------
# Float policy. Accumulation and geometry are float32 (single precision,
# like the reference's default build).
# ---------------------------------------------------------------------------
Float = jnp.float32
Int = jnp.int32

# Matches /root/reference/include/mitsuba/core/constants.h (single precision
# build): Epsilon = 1e-4, ShadowEpsilon = 1e-3, DeltaEpsilon = 1e-3.
EPSILON = 1e-4
SHADOW_EPSILON = 1e-3
DELTA_EPSILON = 1e-3
# Computed host-side with numpy, so importing this module puts no work on
# the device.
ONE_MINUS_EPS = float(np.float32(1.0) - np.finfo(np.float32).epsneg)
INF = float("inf")
MAX_FLOAT = 3.4028235e38

INVALID = -1  # sentinel index (no shape / no emitter / no texture)


def static_field(**kwargs):
    """Field excluded from the pytree flatten (static aux data)."""
    return dataclasses.field(metadata={"pytree_node": False}, **kwargs)


def pytree_dataclass(cls: type[T]) -> type[T]:
    """A frozen dataclass registered as a JAX pytree.

    Fields declared with :func:`static_field` become static aux data (must be
    hashable); everything else is a child node.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("pytree_node", True):
            data_fields.append(f.name)
        else:
            meta_fields.append(f.name)

    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )

    def replace(self: T, **updates: Any) -> T:
        return dataclasses.replace(self, **updates)

    cls.replace = replace  # type: ignore[attr-defined]
    return cls


def asarray_f(x) -> jax.Array:
    return jnp.asarray(x, dtype=Float)


def asarray_i(x) -> jax.Array:
    return jnp.asarray(x, dtype=Int)
