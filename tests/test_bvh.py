"""BVH builder invariants and traversal correctness (bvh.ts semantics)."""

import numpy as np
import jax.numpy as jnp

from wgpu_path_tracing_tpu.accel.bvh import build_bvh
from wgpu_path_tracing_tpu.models.procedural import cornell_box, random_triangles
from wgpu_path_tracing_tpu.models.types import pack_device_scene
from wgpu_path_tracing_tpu.ops.intersect import closest_hit_brute, closest_hit_bvh


def _random_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (n, 3))
    v0 = base
    v1 = base + rng.uniform(-0.5, 0.5, (n, 3))
    v2 = base + rng.uniform(-0.5, 0.5, (n, 3))
    return v0, v1, v2


def test_bvh_structure_invariants():
    v0, v1, v2 = _random_tris(500)
    bvh = build_bvh(v0, v1, v2, max_leaf_size=4, num_bins=12)
    meta = bvh.meta
    n_nodes = meta.shape[0]

    # Permutation covers every triangle exactly once.
    assert sorted(bvh.order.tolist()) == list(range(500))

    # Leaves partition [0, T) exactly; interior children are in range.
    covered = np.zeros(500, bool)
    for i in range(n_nodes):
        left, right, off, cnt = meta[i]
        if cnt > 0:
            assert cnt <= 4
            assert not covered[off : off + cnt].any(), "leaf ranges overlap"
            covered[off : off + cnt] = True
            assert left == -1 and right == -1
        else:
            assert 0 < left < n_nodes and 0 < right < n_nodes
    assert covered.all()

    # Child AABBs are contained in the parent's.
    for i in range(n_nodes):
        left, right, off, cnt = meta[i]
        if cnt == 0:
            for c in (left, right):
                assert np.all(bvh.aabb_min[c] >= bvh.aabb_min[i] - 1e-5)
                assert np.all(bvh.aabb_max[c] <= bvh.aabb_max[i] + 1e-5)

    # Leaf AABBs contain their triangles (in sorted order).
    sv0, sv1, sv2 = v0[bvh.order], v1[bvh.order], v2[bvh.order]
    tmin = np.minimum(np.minimum(sv0, sv1), sv2)
    tmax = np.maximum(np.maximum(sv0, sv1), sv2)
    for i in range(n_nodes):
        _, _, off, cnt = meta[i]
        if cnt > 0:
            assert np.all(tmin[off : off + cnt] >= bvh.aabb_min[i] - 1e-5)
            assert np.all(tmax[off : off + cnt] <= bvh.aabb_max[i] + 1e-5)


def test_bvh_small_inputs():
    for n in range(1, 6):
        v0, v1, v2 = _random_tris(n, seed=n)
        bvh = build_bvh(v0, v1, v2)
        assert sorted(bvh.order.tolist()) == list(range(n))
        if n <= 4:
            assert bvh.num_nodes == 1
            assert bvh.meta[0, 3] == n


def _rays_toward_triangles(tri_isect, n, seed=1, radius=14.0):
    """Rays from random directions aimed at random triangle centroids, so a
    large fraction is guaranteed to hit."""
    rng = np.random.default_rng(seed)
    tri = np.asarray(tri_isect)
    centroids = tri[:, 0:3] + (tri[:, 3:6] + tri[:, 6:9]) / 3.0
    targets = centroids[rng.integers(0, len(tri), n)]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ro = targets - d * radius
    return jnp.asarray(ro, jnp.float32), jnp.asarray(d, jnp.float32)


def test_traversal_matches_brute_force_random_scene():
    scene = pack_device_scene(random_triangles(400, seed=3))
    tri = jnp.asarray(scene["tri_isect"])
    ro, rd = _rays_toward_triangles(tri, 256)

    t_b, idx_b = closest_hit_brute(tri, ro, rd)
    t_v, idx_v = closest_hit_bvh(
        jnp.asarray(scene["bvh_aabb"]),
        jnp.asarray(scene["bvh_meta"]),
        tri,
        ro,
        rd,
    )
    hit_b = np.asarray(idx_b) >= 0
    hit_v = np.asarray(idx_v) >= 0
    assert hit_b.sum() > 20, "test wants real hits"
    np.testing.assert_array_equal(hit_b, hit_v)
    np.testing.assert_allclose(
        np.asarray(t_b)[hit_b], np.asarray(t_v)[hit_v], rtol=1e-5, atol=1e-6
    )
    # Same triangle except possible exact-t ties.
    same = np.asarray(idx_b) == np.asarray(idx_v)
    assert same[hit_b].mean() > 0.99


def test_traversal_matches_brute_force_cornell():
    scene = pack_device_scene(cornell_box())
    tri = jnp.asarray(scene["tri_isect"])
    rng = np.random.default_rng(0)
    ro = jnp.asarray(
        rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (512, 3)), jnp.float32
    )
    d = rng.normal(size=(512, 3))
    rd = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)

    t_b, idx_b = closest_hit_brute(tri, ro, rd)
    t_v, idx_v = closest_hit_bvh(
        jnp.asarray(scene["bvh_aabb"]), jnp.asarray(scene["bvh_meta"]), tri, ro, rd
    )
    # The box is open toward +Z, so some rays legitimately escape; hits and
    # misses must agree exactly between the two strategies.
    hit_b = np.asarray(idx_b) >= 0
    np.testing.assert_array_equal(hit_b, np.asarray(idx_v) >= 0)
    assert hit_b.sum() > 400
    np.testing.assert_allclose(
        np.asarray(t_b)[hit_b], np.asarray(t_v)[hit_b], rtol=1e-5, atol=1e-6
    )


def test_traversal_respects_active_and_tmax():
    scene = pack_device_scene(cornell_box())
    ro = jnp.tile(jnp.array([[0.0, 1.0, 0.0]], jnp.float32), (4, 1))
    rd = jnp.tile(jnp.array([[0.0, -1.0, 0.0]], jnp.float32), (4, 1))
    active = jnp.array([True, False, True, True])
    t, idx = closest_hit_bvh(
        jnp.asarray(scene["bvh_aabb"]),
        jnp.asarray(scene["bvh_meta"]),
        jnp.asarray(scene["tri_isect"]),
        ro,
        rd,
        active=active,
    )
    assert np.asarray(idx)[1] == -1  # inactive lane traced nothing
    assert np.asarray(idx)[0] >= 0
    assert abs(float(t[0]) - 1.0) < 1e-4  # floor at y=0, origin at y=1

    # Any-hit with t_max below the floor distance finds nothing.
    t2, idx2 = closest_hit_bvh(
        jnp.asarray(scene["bvh_aabb"]),
        jnp.asarray(scene["bvh_meta"]),
        jnp.asarray(scene["tri_isect"]),
        ro,
        rd,
        active=active,
        t_max=jnp.full((4,), 0.5, jnp.float32),
        any_hit=True,
    )
    assert not np.any(np.asarray(t2) < 0.5)
