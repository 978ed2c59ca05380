"""Möller-Trumbore and slab-test unit tests (pt.wgsl:123-245 semantics)."""

import numpy as np
import jax.numpy as jnp

from wgpu_path_tracing_tpu.ops.intersect import (
    closest_hit_brute,
    moller_trumbore,
    slab_test,
)


def _tri(v0, v1, v2):
    v0, v1, v2 = (np.asarray(p, np.float32) for p in (v0, v1, v2))
    return (
        jnp.asarray(v0[None]),
        jnp.asarray((v1 - v0)[None]),
        jnp.asarray((v2 - v0)[None]),
    )


def test_triangle_analytic_hit():
    v0, e1, e2 = _tri((-1, -1, -3), (1, -1, -3), (0, 1, -3))
    ro = jnp.array([[0.0, 0.0, 0.0]], jnp.float32)
    rd = jnp.array([[0.0, 0.0, -1.0]], jnp.float32)
    t, u, v, valid = moller_trumbore(ro, rd, v0, e1, e2)
    assert bool(valid[0])
    np.testing.assert_allclose(float(t[0]), 3.0, rtol=1e-6)
    # barycentric check: hit point = (0,0) -> w*v0 + u*v1 + v*v2 = (0, 0, -3)
    w = 1 - float(u[0]) - float(v[0])
    p = w * np.array([-1, -1, -3]) + float(u[0]) * np.array([1, -1, -3]) + float(
        v[0]
    ) * np.array([0, 1, -3])
    np.testing.assert_allclose(p, [0, 0, -3], atol=1e-6)


def test_triangle_miss_and_parallel_and_behind():
    v0, e1, e2 = _tri((-1, -1, -3), (1, -1, -3), (0, 1, -3))
    cases = [
        ((5.0, 5.0, 0.0), (0.0, 0.0, -1.0)),  # outside
        ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),  # parallel to plane
        ((0.0, 0.0, -5.0), (0.0, 0.0, -1.0)),  # triangle behind origin
    ]
    for o, d in cases:
        _, _, _, valid = moller_trumbore(
            jnp.array([o], jnp.float32), jnp.array([d], jnp.float32), v0, e1, e2
        )
        assert not bool(valid[0]), (o, d)


def test_triangle_edge_epsilon():
    # A hit closer than EPSILON is rejected (t > EPSILON, pt.wgsl:157)
    v0, e1, e2 = _tri((-1, -1, -1e-7), (1, -1, -1e-7), (0, 1, -1e-7))
    ro = jnp.array([[0.0, 0.0, 0.0]], jnp.float32)
    rd = jnp.array([[0.0, 0.0, -1.0]], jnp.float32)
    _, _, _, valid = moller_trumbore(ro, rd, v0, e1, e2)
    assert not bool(valid[0])


def test_slab_test_inside_and_outside():
    ro = jnp.array([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0], [0.0, 0.0, 3.0]], jnp.float32)
    rd = jnp.array(
        [[0.0, 0.0, -1.0], [0.577, 0.577, 0.577], [0.0, 0.0, -1.0]], jnp.float32
    )
    bmin = jnp.array([-1.0, -1.0, -1.0], jnp.float32)
    bmax = jnp.array([1.0, 1.0, 1.0], jnp.float32)
    hit, _ = slab_test(ro, rd, bmin[None], bmax[None])
    assert bool(hit[0])  # origin inside
    assert not bool(hit[1])  # pointing away
    assert bool(hit[2])  # approaching along -z


def test_brute_force_first_hit_wins_ties():
    # Two coincident triangles: the lower index must win (strict <,
    # pt.wgsl:275 keeps the first).
    tri = np.zeros((2, 9), np.float32)
    for i in range(2):
        tri[i, 0:3] = (-1, -1, -3)
        tri[i, 3:6] = (2, 0, 0)
        tri[i, 6:9] = (1, 2, 0)
    t, idx = closest_hit_brute(
        jnp.asarray(tri),
        jnp.array([[0.0, 0.0, 0.0]], jnp.float32),
        jnp.array([[0.0, 0.0, -1.0]], jnp.float32),
    )
    assert int(idx[0]) == 0


def test_brute_force_chunking_consistency():
    rng = np.random.default_rng(5)
    base = rng.uniform(-3, 3, (97, 3)).astype(np.float32)  # odd count
    tri = np.zeros((97, 9), np.float32)
    tri[:, 0:3] = base
    tri[:, 3:6] = rng.uniform(-1, 1, (97, 3))
    tri[:, 6:9] = rng.uniform(-1, 1, (97, 3))
    ro = jnp.asarray(rng.uniform(-5, 5, (64, 3)), jnp.float32)
    d = rng.normal(size=(64, 3))
    rd = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    t1, i1 = closest_hit_brute(jnp.asarray(tri), ro, rd, chunk=8)
    t2, i2 = closest_hit_brute(jnp.asarray(tri), ro, rd, chunk=97)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    hit = np.asarray(i1) >= 0
    np.testing.assert_array_equal(np.asarray(t1)[hit], np.asarray(t2)[hit])
