"""Pallas kernels (Triton route) for the GPU intersection path.

Two kernels, each one block of rays per program, written against the same
f32 Möller-Trumbore (pt.wgsl:123-157, EPSILON = 1e-6) and slab test
(pt.wgsl:234-245) as the plain references in ops/intersect.py:

* ``closest_hit_dense`` — every ray against every triangle. A block of
  ``DENSE_RAYS`` rays stays in registers while an in-kernel ``fori_loop``
  streams the triangle table (SoA, ``DENSE_TRIS`` triangles a step)
  through it; (best_t, best_idx) are written once at the end. Ties keep
  the FIRST triangle index (the reference's strict ``hit.t < closest.t``,
  pt.wgsl:275): first-index min within a step, strict ``<`` across steps.
  Reference: ``closest_hit_brute``.
* ``closest_hit_bvh_kernel`` — the reference's per-thread traversal
  (pt.wgsl:248-296) over the threaded binary BVH (accel/bvh.py::
  build_links): each ray follows its own hit/miss links with node, box and
  triangle rows gathered from device memory, in the same left-first visit
  order as ``closest_hit_bvh_linked``. The whole ``while_loop`` runs inside
  one program per ``BVH_RAYS`` rays, so a block stops when its own rays
  finish and no loop predicate goes back to the host. Closest hit, and
  any-hit with ``t_max`` / ``active`` for shadow rays.

Both take SoA rays: (3, N) origins and directions. ``interpret=True`` runs
them through the Pallas interpreter (CPU tests); callers pass it
explicitly, it is never derived from the backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

EPSILON = 1e-6  # pt.wgsl:4

# Block shapes (powers of two, as Triton requires), one ray per thread,
# tuned on an H100 (tools/kernel_ab.py, PERF.md).
DENSE_RAYS = 128
DENSE_TRIS = 16
DENSE_WARPS = 4
BVH_RAYS = 32
BVH_WARPS = 1


def _dot3(x0, x1, x2, y0, y1, y2):
    # The association of XLA's sequential axis reduction
    # (ops/intersect.py::_dot): with multiply-add contraction both become
    # fma(x2, y2, fma(x1, y1, x0 * y0)).
    return x2 * y2 + (x1 * y1 + x0 * y0)


def _mt(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z):
    """Component-wise Möller-Trumbore; returns (t, valid)."""
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = _dot3(e1x, e1y, e1z, hx, hy, hz)
    f = 1.0 / a
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * _dot3(sx, sy, sz, hx, hy, hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * _dot3(dx, dy, dz, qx, qy, qz)
    t = f * _dot3(e2x, e2y, e2z, qx, qy, qz)
    valid = (
        (jnp.abs(a) >= EPSILON)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPSILON)
    )
    return t, valid


def _pad_rays(ro3, rd3, block):
    rays = jnp.concatenate([ro3, rd3], axis=0).astype(jnp.float32)
    n = rays.shape[1]
    pad = (-n) % block
    if pad:
        rays = jnp.pad(rays, ((0, 0), (0, pad)))
    return rays, n


def _dense_kernel(bn: int, bt: int, n_steps: int):
    def kernel(rays_ref, tri_ref, t_ref, idx_ref):
        lanes = pl.ds(pl.program_id(0) * bn, bn)
        ray = [rays_ref[c, lanes][None, :] for c in range(6)]
        rows = jax.lax.broadcasted_iota(jnp.int32, (bt, bn), 0)

        def step(j, carry):
            best_t, best_idx = carry
            tris = pl.ds(j * bt, bt)
            tri = [tri_ref[c, tris][:, None] for c in range(9)]
            t, valid = _mt(*ray, *tri)
            t = jnp.where(valid, t, jnp.inf)
            min_t = jnp.min(t, axis=0)
            min_row = jnp.min(jnp.where(t == min_t[None, :], rows, bt), axis=0)
            better = min_t < best_t
            return (jnp.where(better, min_t, best_t),
                    jnp.where(better, j * bt + min_row, best_idx))

        best_t, best_idx = jax.lax.fori_loop(
            0, n_steps, step,
            (jnp.full((bn,), jnp.inf, jnp.float32),
             jnp.full((bn,), -1, jnp.int32)))
        t_ref[lanes] = best_t
        idx_ref[lanes] = best_idx

    return kernel


@functools.partial(jax.jit, static_argnames=("interpret",))
def closest_hit_dense(tri_isect, ro3, rd3, interpret: bool = False):
    """Dense closest hit. tri_isect: (T, 9) [v0, e1, e2]; ro3, rd3: (3, N).

    Returns (t, idx) with t = inf, idx = -1 for misses. Padding triangles
    are all-zero rows (a == 0, never valid)."""
    rays, n = _pad_rays(ro3, rd3, DENSE_RAYS)
    num_tris = tri_isect.shape[0]
    bt = min(DENSE_TRIS, pl.next_power_of_2(max(num_tris, 1)))
    tri = tri_isect.astype(jnp.float32).T  # (9, T): one row per component
    t_pad = (-num_tris) % bt
    if t_pad:
        tri = jnp.pad(tri, ((0, 0), (0, t_pad)))
    n_pad = rays.shape[1]
    t, idx = pl.pallas_call(
        _dense_kernel(DENSE_RAYS, bt, tri.shape[1] // bt),
        grid=(n_pad // DENSE_RAYS,),
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        ],
        compiler_params=pl_triton.CompilerParams(num_warps=DENSE_WARPS),
        backend="triton",
        interpret=interpret,
        name="closest_hit_dense",
    )(rays, tri)
    return t[:n], idx[:n]


def _bvh_kernel(bn: int, leaf_size: int, any_hit: bool, max_steps: int):
    def kernel(rays_ref, node0_ref, tmax_ref, aabb_ref, nodes_ref, tri_ref,
               t_ref, idx_ref):
        lanes = pl.ds(pl.program_id(0) * bn, bn)
        ray = [rays_ref[c, lanes] for c in range(6)]
        o, d = ray[:3], ray[3:]
        t_max = tmax_ref[lanes]

        def cond(carry):
            node, _, _, steps = carry
            return (jnp.max(node) >= 0) & (steps < max_steps)

        def body(carry):
            node, best_t, best_idx, steps = carry
            valid = node >= 0
            safe = jnp.maximum(node, 0)
            t_near = t_far = None
            nan = valid & False
            for k in range(3):
                t1 = (aabb_ref[safe, k] - o[k]) / d[k]
                t2 = (aabb_ref[safe, 3 + k] - o[k]) / d[k]
                # Triton's min/max drop NaN operands where XLA's propagate
                # them; a 0/0 slab makes the XLA reference miss the box.
                nan = nan | (t1 != t1) | (t2 != t2)
                lo, hi = jnp.minimum(t1, t2), jnp.maximum(t1, t2)
                t_near = lo if t_near is None else jnp.maximum(t_near, lo)
                t_far = hi if t_far is None else jnp.minimum(t_far, hi)
            # Best-t / t_max culling: children's entry is never below the
            # parent's, so skipping a culled subtree is exact.
            limit = jnp.minimum(best_t, t_max)
            box_hit = (valid & ~nan & (t_far >= t_near) & (t_far >= 0.0)
                       & (t_near <= limit))
            hit_link = nodes_ref[safe, 0]
            miss_link = nodes_ref[safe, 1]
            offset = nodes_ref[safe, 2]
            count = nodes_ref[safe, 3]
            do_leaf = box_hit & (count > 0)
            for i in range(leaf_size):
                do = do_leaf & (i < count)
                tri = jnp.where(do, offset + i, 0)
                t, ok = _mt(*ray, *(tri_ref[tri, c] for c in range(9)))
                better = do & ok & (t < best_t)
                best_t = jnp.where(better, t, best_t)
                best_idx = jnp.where(better, tri, best_idx)
            nxt = jnp.where(box_hit, hit_link, miss_link)
            nxt = jnp.where(valid, nxt, -1)
            if any_hit:
                nxt = jnp.where(best_t < t_max, -1, nxt)
            return nxt, best_t, best_idx, steps + 1

        _, best_t, best_idx, _ = jax.lax.while_loop(
            cond, body,
            (node0_ref[lanes], jnp.full((bn,), jnp.inf, jnp.float32),
             jnp.full((bn,), -1, jnp.int32), jnp.int32(0)))
        t_ref[lanes] = best_t
        idx_ref[lanes] = best_idx

    return kernel


@functools.partial(
    jax.jit, static_argnames=("leaf_size", "any_hit", "interpret"))
def closest_hit_bvh_kernel(bvh_aabb, bvh_nodes, tri_isect, ro3, rd3,
                           active=None, t_max=None, leaf_size: int = 4,
                           any_hit: bool = False, interpret: bool = False):
    """Threaded-BVH closest hit / any-hit, one ray per thread.

    bvh_aabb: (B, 6) [min, max]; bvh_nodes: (B, 4) i32 [hit_link,
    miss_link, triangleOffset, triangleCount] (link -1 ends the walk);
    tri_isect: (T, 9); ro3, rd3: (3, N); active: (N,) bool; t_max: (N,)
    upper bound on t (shadow rays). Same contract as
    ops/intersect.py::closest_hit_bvh_linked."""
    rays, n = _pad_rays(ro3, rd3, BVH_RAYS)
    n_pad = rays.shape[1]
    if active is None:
        active = jnp.ones((n,), bool)
    node0 = jnp.pad(jnp.where(active, 0, -1).astype(jnp.int32),
                    (0, n_pad - n), constant_values=-1)
    if t_max is None:
        t_max = jnp.full((n,), jnp.inf, jnp.float32)
    t_max = jnp.pad(t_max.astype(jnp.float32), (0, n_pad - n))
    # A threaded walk visits each node at most once.
    max_steps = bvh_nodes.shape[0] + 1
    t, idx = pl.pallas_call(
        _bvh_kernel(BVH_RAYS, leaf_size, any_hit, max_steps),
        grid=(n_pad // BVH_RAYS,),
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        ],
        compiler_params=pl_triton.CompilerParams(num_warps=BVH_WARPS),
        backend="triton",
        interpret=interpret,
        name="closest_hit_bvh",
    )(rays, node0, t_max, bvh_aabb.astype(jnp.float32),
      bvh_nodes.astype(jnp.int32), tri_isect.astype(jnp.float32))
    return t[:n], idx[:n]
