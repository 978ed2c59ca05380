"""SoA vec3 helpers.

All device math in this framework runs structure-of-arrays: a vec3 is a
``V3`` of three lane-shaped (N,) arrays, so every component is a
contiguous, coalesced row and no op works on a padded (N, 3) minor axis.
The shading code (ops/bsdf.py, ops/lights.py, ops/shade.py, ops/trace.py)
is written against it.
"""

from __future__ import annotations

import typing

import jax.numpy as jnp


class V3(typing.NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

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


def splat(c, like) -> V3:
    """Constant vec3 broadcast to the lane shape of ``like``."""
    one = jnp.ones_like(like)
    return V3(one * c[0], one * c[1], one * c[2])


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: V3):
    return jnp.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    inv = 1.0 / length(a)
    return V3(a.x * inv, a.y * inv, a.z * inv)


def where(mask, a: V3, b: V3) -> V3:
    return V3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def maxcomp(a: V3):
    return jnp.maximum(jnp.maximum(a.x, a.y), a.z)


def any_positive(a: V3):
    return (a.x > 0.0) | (a.y > 0.0) | (a.z > 0.0)


def clamp_max(a: V3, hi) -> V3:
    return V3(jnp.minimum(a.x, hi), jnp.minimum(a.y, hi), jnp.minimum(a.z, hi))


def from_rows(arr, base: int) -> V3:
    """Three consecutive rows of a (C, lanes) SoA table as a V3."""
    return V3(arr[base], arr[base + 1], arr[base + 2])


def stack_cols(v: V3):
    """(lanes, 3) AoS view (for kernel/host boundaries only)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def stack_rows(v: V3):
    """(3, lanes) SoA array — a cheap row concat, no transpose."""
    return jnp.stack([v.x, v.y, v.z], axis=0)


def from_cols(arr) -> V3:
    """(lanes, 3) AoS array -> V3 (boundary helper)."""
    return V3(arr[..., 0], arr[..., 1], arr[..., 2])
