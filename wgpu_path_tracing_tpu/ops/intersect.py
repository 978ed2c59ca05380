"""Ray-scene intersection kernels (device-side, vectorized).

The plain-XLA references, and the selection between them and the GPU
kernels of ops/pallas_kernels.py (``make_closest_hit``):

1. ``closest_hit_brute`` — dense all-rays x all-triangles Möller-Trumbore,
   scanned over fixed-size triangle chunks: for small scenes (the
   Cornell-class benchmarks) every ray does identical work on contiguous
   data.

2. ``closest_hit_bvh_linked`` — the threaded-BVH walk (hit/miss links,
   accel/bvh.py::build_links) with one ``lax.while_loop`` stepping all
   rays together, masked.

3. ``closest_hit_bvh`` — batched traversal with a fixed-depth per-ray
   stack (the reference uses 64 entries, pt.wgsl:249); the CPU oracle.

The walks unroll leaf loops to the static build-time leaf size (default 4,
bvh.ts:86) and add ordered t-culling (skip nodes whose AABB entry exceeds
the current best hit) and optional any-hit early exit for shadow rays —
performance wins that cannot change which closest hit is returned.

Intersection math mirrors pt.wgsl:123-157 (Möller-Trumbore with
EPSILON = 1e-6) and pt.wgsl:234-245 (slab AABB test). Triangles are
pre-packed as [v0, e1, e2] rows (models/types.py) — the reference derives
edges per test (pt.wgsl:128-129); precomputing them is float-identical.

Tie-breaking: the reference keeps the FIRST hit found at equal t in traversal
order (strict ``hit.t < closest.t``, pt.wgsl:275). The brute path's
first-occurrence argmin over index order matches for index-ordered ties; BVH
visit order matches the reference's (right pushed first, left popped first).

Returns (t, idx): idx == -1 and t == +inf mean miss.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

EPSILON = 1e-6  # pt.wgsl:4
INF = np.float32(np.inf)  # np, not jnp: module-level jnp constants init the backend at import


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def moller_trumbore(ro, rd, v0, e1, e2):
    """Batched Möller-Trumbore (pt.wgsl:123-157). All args broadcastable
    (..., 3). Returns (t, u, v, valid)."""
    h = _cross(rd, e2)
    a = _dot(e1, h)
    f = 1.0 / a
    s = ro - v0
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(rd, q)
    t = f * _dot(e2, q)
    valid = (
        (jnp.abs(a) >= EPSILON)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPSILON)
    )
    return t, u, v, valid


def slab_test(ro, rd, box_min, box_max):
    """Slab AABB test (pt.wgsl:234-245). Returns (hit, t_near)."""
    t1 = (box_min - ro) / rd
    t2 = (box_max - ro) / rd
    tmin = jnp.minimum(t1, t2)
    tmax = jnp.maximum(t1, t2)
    t_near = jnp.max(tmin, axis=-1)
    t_far = jnp.min(tmax, axis=-1)
    return (t_far >= t_near) & (t_far >= 0.0), t_near


@functools.partial(jax.jit, static_argnames=("chunk",))
def closest_hit_brute(tri_isect, ro, rd, chunk: int = 256):
    """Dense closest hit: every ray against every triangle.

    tri_isect: (T, 9) [v0, e1, e2]; ro, rd: (N, 3).
    Scans over triangle chunks to bound the (N, chunk) working set.
    """
    num_tris = tri_isect.shape[0]
    chunk = min(chunk, max(num_tris, 1))
    pad = (-num_tris) % chunk
    if pad:
        # Zero triangles have a == 0 -> always invalid.
        tri_isect = jnp.concatenate(
            [tri_isect, jnp.zeros((pad, 9), tri_isect.dtype)], axis=0
        )
    num_chunks = tri_isect.shape[0] // chunk
    chunks = tri_isect.reshape(num_chunks, chunk, 9)

    n = ro.shape[0]
    ro_b = ro[:, None, :]
    rd_b = rd[:, None, :]

    def step(carry, tri_chunk_and_base):
        best_t, best_idx = carry
        tri_chunk, base = tri_chunk_and_base
        v0 = tri_chunk[None, :, 0:3]
        e1 = tri_chunk[None, :, 3:6]
        e2 = tri_chunk[None, :, 6:9]
        t, _, _, valid = moller_trumbore(ro_b, rd_b, v0, e1, e2)
        t = jnp.where(valid, t, INF)
        c_idx = jnp.argmin(t, axis=1)
        c_t = jnp.min(t, axis=1)
        better = c_t < best_t
        best_t = jnp.where(better, c_t, best_t)
        best_idx = jnp.where(better, base + c_idx.astype(jnp.int32), best_idx)
        return (best_t, best_idx), None

    bases = jnp.arange(num_chunks, dtype=jnp.int32) * chunk
    init = (jnp.full((n,), INF), jnp.full((n,), -1, jnp.int32))
    (best_t, best_idx), _ = jax.lax.scan(step, init, (chunks, bases))
    return best_t, best_idx


@functools.partial(
    jax.jit,
    static_argnames=("leaf_size", "stack_depth", "any_hit", "max_steps"),
)
def closest_hit_bvh(
    bvh_aabb,
    bvh_meta,
    tri_isect,
    ro,
    rd,
    active=None,
    t_max=None,
    leaf_size: int = 4,
    stack_depth: int = 64,
    any_hit: bool = False,
    max_steps: int = 1_000_000,
):
    """Batched BVH traversal with per-ray fixed stacks.

    bvh_aabb: (B, 6) [min, max]; bvh_meta: (B, 4) i32 [left, right, offset,
    count]; tri_isect: (T, 9); ro/rd: (N, 3); active: (N,) bool lanes to
    trace; t_max: (N,) optional upper bound (shadow rays); any_hit: stop a
    lane as soon as any hit below t_max is found.
    """
    n = ro.shape[0]
    ar = jnp.arange(n)
    if active is None:
        active = jnp.ones((n,), bool)
    has_tmax = t_max is not None

    stack = jnp.zeros((n, stack_depth), jnp.int32)  # slot 0 == root (index 0)
    sp0 = jnp.where(active, 1, 0).astype(jnp.int32)
    best_t0 = jnp.full((n,), INF)
    best_idx0 = jnp.full((n,), -1, jnp.int32)

    def cond(carry):
        _, sp, _, _, steps = carry
        return jnp.any(sp > 0) & (steps < max_steps)

    def body(carry):
        stack, sp, best_t, best_idx, steps = carry
        has = sp > 0
        spm1 = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack, spm1[:, None], axis=1)[:, 0]
        node = jnp.where(has, node, 0)

        aabb = bvh_aabb[node]
        box_hit, t_near = slab_test(ro, rd, aabb[:, 0:3], aabb[:, 3:6])
        # Ordered culling: a node entered beyond the current best (or the
        # shadow bound) cannot contain a closer hit. Not in the reference
        # (pt.wgsl:266 tests the box only) — result-identical, fewer steps.
        limit = jnp.minimum(best_t, t_max) if has_tmax else best_t
        box_hit = box_hit & (t_near <= limit)
        process = has & box_hit

        meta = bvh_meta[node]
        count = meta[:, 3]
        is_leaf = count > 0

        do_leaf = process & is_leaf
        for i in range(leaf_size):
            do = do_leaf & (i < count)
            tri = jnp.where(do, meta[:, 2] + i, 0)
            tdata = tri_isect[tri]
            t, _, _, valid = moller_trumbore(
                ro, rd, tdata[:, 0:3], tdata[:, 3:6], tdata[:, 6:9]
            )
            better = do & valid & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_idx = jnp.where(better, tri, best_idx)

        # Interior: overwrite popped slot with right child, push left above
        # it — left is popped first, matching pt.wgsl:281-287.
        push = process & ~is_leaf
        slot2 = jnp.minimum(spm1 + 1, stack_depth - 1)
        cur0 = jnp.take_along_axis(stack, spm1[:, None], axis=1)[:, 0]
        cur1 = jnp.take_along_axis(stack, slot2[:, None], axis=1)[:, 0]
        stack = jax.vmap(lambda s, i, v: s.at[i].set(v))(
            stack, spm1, jnp.where(push, meta[:, 1], cur0)
        )
        stack = jax.vmap(lambda s, i, v: s.at[i].set(v))(
            stack, slot2, jnp.where(push, meta[:, 0], cur1)
        )
        sp = jnp.where(has, jnp.where(push, spm1 + 2, spm1), sp)

        if any_hit:
            found = best_t < (t_max if has_tmax else INF)
            sp = jnp.where(found, 0, sp)

        return stack, sp, best_t, best_idx, steps + 1

    _, _, best_t, best_idx, _ = jax.lax.while_loop(
        cond, body, (stack, sp0, best_t0, best_idx0, jnp.int32(0))
    )
    return best_t, best_idx


@functools.partial(
    jax.jit,
    static_argnames=("leaf_size", "any_hit", "max_steps"),
)
def closest_hit_bvh_linked(
    bvh_aabb,
    bvh_nodes,
    tri_isect,
    ro,
    rd,
    active=None,
    t_max=None,
    leaf_size: int = 4,
    any_hit: bool = False,
    max_steps: int = 4_000_000,
):
    """Stackless threaded-BVH traversal (plain-XLA reference).

    Each ray walks the tree through precomputed hit/miss links
    (accel/bvh.py::build_links) in left-first DFS order — the same visit
    order as the reference's explicit stack (pt.wgsl:260-287), with zero
    per-ray state beyond the current node index: no stacks, no scatters,
    every step is two row gathers + vector math. Adds best-t culling
    (children's AABB entry >= parent's, so skipping a culled subtree is
    exact).

    bvh_nodes: (B, 4) i32 [hit_link, miss_link, triangleOffset,
    triangleCount]; node -1 terminates a lane.
    """
    n = ro.shape[0]
    if active is None:
        active = jnp.ones((n,), bool)
    has_tmax = t_max is not None

    node0 = jnp.where(active, 0, -1).astype(jnp.int32)
    best_t0 = jnp.full((n,), INF)
    best_idx0 = jnp.full((n,), -1, jnp.int32)

    def cond(carry):
        node, _, _, steps = carry
        return jnp.any(node >= 0) & (steps < max_steps)

    def body(carry):
        node, best_t, best_idx, steps = carry
        valid = node >= 0
        safe = jnp.maximum(node, 0)

        aabb = bvh_aabb[safe]
        box_hit, t_near = slab_test(ro, rd, aabb[:, 0:3], aabb[:, 3:6])
        limit = jnp.minimum(best_t, t_max) if has_tmax else best_t
        box_hit = valid & box_hit & (t_near <= limit)

        meta = bvh_nodes[safe]
        count = meta[:, 3]
        do_leaf = box_hit & (count > 0)
        for i in range(leaf_size):
            do = do_leaf & (i < count)
            tri = jnp.where(do, meta[:, 2] + i, 0)
            tdata = tri_isect[tri]
            t, _, _, tri_valid = moller_trumbore(
                ro, rd, tdata[:, 0:3], tdata[:, 3:6], tdata[:, 6:9]
            )
            better = do & tri_valid & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_idx = jnp.where(better, tri, best_idx)

        next_node = jnp.where(box_hit, meta[:, 0], meta[:, 1])
        next_node = jnp.where(valid, next_node, -1)
        if any_hit:
            found = best_t < (t_max if has_tmax else INF)
            next_node = jnp.where(found, -1, next_node)
        return next_node, best_t, best_idx, steps + 1

    _, best_t, best_idx, _ = jax.lax.while_loop(
        cond, body, (node0, best_t0, best_idx0, jnp.int32(0))
    )
    return best_t, best_idx


INTERSECTORS = ("auto", "brute", "bvh", "stack")


def make_closest_hit(scene, intersector: str, brute_max_tris: int, leaf_size: int):
    """Pick the intersection strategy for this scene (static decision).

    ``intersector``: "auto" (dense below ``brute_max_tris`` triangles, the
    threaded-BVH walk above), or force "brute" (dense) / "bvh" (threaded
    walk) / "stack" (per-ray fixed-stack while_loop — the literal
    pt.wgsl:248-296 shape, kept as a CPU-side oracle, not a production
    path). Each strategy has one implementation per backend: the Pallas
    kernels of ops/pallas_kernels.py on ``gpu``, the plain XLA references
    of this module elsewhere.

    Returns closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False)
    taking SoA (3, N) origin/direction arrays, tagged with ``.strategy``
    ("dense_kernel", "dense_xla", "bvh_kernel", "bvh_xla" or "stack").
    """
    if intersector not in INTERSECTORS:
        raise ValueError(
            f"unknown intersector {intersector!r}; expected one of "
            f"{INTERSECTORS}")
    num_tris = scene["tri_isect"].shape[0]
    on_gpu = jax.default_backend() == "gpu"

    if intersector == "stack":

        def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False):
            return closest_hit_bvh(
                scene["bvh_aabb"],
                scene["bvh_meta"],
                scene["tri_isect"],
                ro3.T,
                rd3.T,
                active=active,
                t_max=t_max,
                leaf_size=leaf_size,
                any_hit=any_hit,
            )

        closest_hit.strategy = "stack"
        return closest_hit

    if intersector == "brute" or (
        intersector == "auto" and num_tris <= brute_max_tris
    ):

        def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False):
            del active, t_max, any_hit
            if on_gpu:
                from wgpu_path_tracing_tpu.ops.pallas_kernels import (
                    closest_hit_dense,
                )

                return closest_hit_dense(scene["tri_isect"], ro3, rd3)
            return closest_hit_brute(scene["tri_isect"], ro3.T, rd3.T)

        closest_hit.strategy = "dense_kernel" if on_gpu else "dense_xla"
        return closest_hit

    def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False):
        # Concatenated inside the traced call, where XLA fuses it: the
        # renderer builds this closure at scene load just to read
        # .strategy.
        bvh_nodes = jnp.concatenate(
            [scene["bvh_links"], scene["bvh_meta"][:, 2:4]], axis=1
        )
        if on_gpu:
            from wgpu_path_tracing_tpu.ops.pallas_kernels import (
                closest_hit_bvh_kernel,
            )

            return closest_hit_bvh_kernel(
                scene["bvh_aabb"], bvh_nodes, scene["tri_isect"], ro3, rd3,
                active=active, t_max=t_max, leaf_size=leaf_size,
                any_hit=any_hit,
            )
        return closest_hit_bvh_linked(
            scene["bvh_aabb"],
            bvh_nodes,
            scene["tri_isect"],
            ro3.T,
            rd3.T,
            active=active,
            t_max=t_max,
            leaf_size=leaf_size,
            any_hit=any_hit,
        )

    closest_hit.strategy = "bvh_kernel" if on_gpu else "bvh_xla"
    return closest_hit
