"""Multi-chip rendering via jax.sharding.Mesh + shard_map.

The reference is single-device (SURVEY.md §2.4: the only parallelism is
per-pixel SIMT on one GPU). The scale-out design:

* a 2D logical mesh ("sample", "row"),
* the scene is REPLICATED to every device (it is small relative to device
  memory; the
  reference likewise uploads the whole scene to its one device,
  renderer.ts:242-355),
* the pixel grid is sharded by row blocks along "row" (each chip renders
  rows [r·H/nr, (r+1)·H/nr) — RNG seeds use GLOBAL pixel coordinates so a
  sharded render equals the single-chip render),
* frames (1-spp passes) are round-robined along "sample"; each chip
  accumulates a local sum and one ``psum`` over "sample" merges the chunk —
  tiles are otherwise fully independent (no other collectives, matching
  SURVEY.md §2.4's psum-free tile analysis).

All communication is a single psum per chunk (NCCL on GPUs); there is no
host-side gather until the caller fetches the final image.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from wgpu_path_tracing_tpu.ops import camera_rays as CAM
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu.render.pipeline import make_trace_fn


def make_mesh(devices=None, sample_shards: int | None = None) -> Mesh:
    """Build a ("sample", "row") mesh over the given devices.

    With n devices and sample_shards s (default: 2 if n is even and > 2,
    else 1), the mesh is (s, n // s).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if sample_shards is None:
        sample_shards = 2 if (n > 2 and n % 2 == 0) else 1
    assert n % sample_shards == 0, (n, sample_shards)
    arr = np.asarray(devices).reshape(sample_shards, n // sample_shards)
    return Mesh(arr, ("sample", "row"))


def replicate_scene(scene, mesh: Mesh):
    """Place every scene table replicated across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), scene)


def shard_accum(accum, mesh: Mesh):
    """Shard the (H*W, 3) accumulation buffer by row blocks."""
    return jax.device_put(accum, NamedSharding(mesh, P("row", None)))


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "n_frames",
        "width",
        "height",
        "use_dof",
        "rng_mode",
        "max_bounces",
        "do_mis",
        "num_lights",
        "firefly_clamp",
        "intersector",
        "brute_max_tris",
        "leaf_size",
        "slots_used",
        "n_active",
        "frames_per_trace",
    ),
    donate_argnames=("accum",),
)
def render_chunk_sharded(
    scene,
    cam,
    accum,
    frame_start,
    *,
    mesh: Mesh,
    n_frames: int,
    width: int,
    height: int,
    use_dof: bool,
    rng_mode: str = "reference",
    max_bounces: int = 8,
    do_mis: bool = True,
    num_lights: int = 0,
    firefly_clamp: float = 2.5,
    intersector: str = "auto",
    brute_max_tris: int = 512,
    leaf_size: int = 4,
    slots_used: tuple = (True, True, True, True),
    n_active: int | None = None,
    frames_per_trace: int = 1,
):
    """Sharded equivalent of render/pipeline.py::render_chunk.

    accum: (H*W, 3) sharded P("row", None). Renders ``n_frames`` 1-spp
    frames (must divide by the sample axis) and folds them into the running
    mean. ``n_active`` (default n_frames) limits how many of those frames
    actually contribute — the tail frames run but are zero-weighted, which
    lets a caller land on an exact total spp that isn't a multiple of the
    sample axis. Returns (accum, counters[2] int32).

    ``frames_per_trace`` batches F of a shard's local frames into ONE
    trace call per scan step, same rationale and radiance-difference
    class as render_chunk. The effective F is
    gcd-clamped to divide the local frame count, and drops to 1 on a
    zero-weighted-tail chunk (n_active < n_frames, the final sub-multiple
    only) so per-frame weights and ray counters stay exact.
    """
    import math

    ns = mesh.shape["sample"]
    nr = mesh.shape["row"]
    assert n_frames % ns == 0, (n_frames, ns)
    assert height % nr == 0, (height, nr)
    if n_active is None:
        n_active = n_frames
    assert 0 < n_active <= n_frames, (n_active, n_frames)
    local_frames = n_frames // ns
    local_rows = height // nr
    fpt = math.gcd(max(1, int(frames_per_trace)), local_frames)
    if n_active != n_frames:
        fpt = 1

    scene_specs = jax.tree.map(lambda _: P(), scene)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(scene_specs, P(), P("row", None), P()),
        out_specs=(P("row", None), P()),
        check_vma=False,
    )
    def fn(scene, cam, accum_tile, frame_start):
        from wgpu_path_tracing_tpu.utils.tiling import tile_permutation

        s_idx = jax.lax.axis_index("sample")
        r_idx = jax.lax.axis_index("row")
        x, y = CAM.pixel_grid(width, local_rows)
        # Tile-coherent lane order within the shard's row band (matching
        # render/pipeline.py; un-permute with untile_image on readout).
        perm = jnp.asarray(tile_permutation(width, local_rows))
        x = x[perm]
        y = y[perm] + r_idx * local_rows  # global rows -> global RNG seeds
        closest_hit = make_closest_hit(scene, intersector, brute_max_tris, leaf_size)
        trace_fn = make_trace_fn(
            scene, closest_hit,
            max_bounces=max_bounces, do_mis=do_mis, num_lights=num_lights,
            slots_used=slots_used, rng_mode=rng_mode,
        )

        n_loc = local_rows * width

        def step(carry, k):
            local_sum, counters = carry
            # Local frame j = k*fpt + i maps to global in-chunk index
            # j*ns + s_idx (frames round-robin the sample axis, same
            # schedule as fpt=1 — RNG streams are unchanged).
            parts = []
            weights = []
            for i in range(fpt):
                in_chunk = (k * fpt + jnp.int32(i)) * ns + s_idx
                frame = frame_start + in_chunk
                parts.append(CAM.generate_rays(
                    cam, x, y, frame, use_dof=use_dof, rng_mode=rng_mode
                ))
                weights.append(in_chunk < n_active)
            if fpt == 1:
                ro, rd, state = parts[0]
            else:
                ro = jnp.concatenate([p[0] for p in parts])
                rd = jnp.concatenate([p[1] for p in parts])
                state = jnp.concatenate([p[2] for p in parts])
            lds0 = None
            if trace_fn.lds_active:
                ldss = [CAM.bounce0_lds(
                    x, y, frame_start + (k * fpt + jnp.int32(i)) * ns + s_idx)
                    for i in range(fpt)]
                lds0 = (ldss[0] if fpt == 1
                        else jnp.concatenate(ldss, axis=1))
            radiance, state, stats = trace_fn(ro, rd, state, lds0)
            # Frames past n_active run (uniform trip count across shards)
            # but contribute nothing. fpt > 1 only on full-weight chunks
            # (see above), where the batched stats cover exactly the
            # contributing frames.
            if fpt == 1:
                wi = weights[0].astype(jnp.int32)
            else:
                wi = jnp.int32(1)
            counters = counters + wi * jnp.stack(
                [stats["closest"], stats["shadow"]]
            )
            for i in range(fpt):
                color = jnp.minimum(radiance[i * n_loc : (i + 1) * n_loc],
                                    jnp.float32(firefly_clamp))
                local_sum = local_sum + weights[i].astype(jnp.float32) * color
            return (local_sum, counters), None

        init = (
            jnp.zeros((n_loc, 3), jnp.float32),
            jnp.zeros((2,), jnp.int32),
        )
        (local_sum, counters), _ = jax.lax.scan(
            step, init, jnp.arange(local_frames // fpt, dtype=jnp.int32)
        )

        chunk_sum = jax.lax.psum(local_sum, "sample")
        counters = jax.lax.psum(counters, ("sample", "row"))
        chunk_mean = chunk_sum / jnp.float32(n_active)

        # Fold the chunk into the running mean: with F old frames and C new,
        # new_mean = old*(F/(F+C)) + chunk*(C/(F+C)) — reduces to overwrite
        # at frame_start == 0 (pt.wgsl:754-759 semantics).
        fs = frame_start.astype(jnp.float32)
        t = jnp.float32(n_active) / (fs + jnp.float32(n_active))
        new_accum = accum_tile * (1.0 - t) + chunk_mean * t
        return new_accum, counters

    return fn(scene, cam, accum, frame_start)


def gather_image(accum) -> np.ndarray:
    """Fetch the (possibly sharded) accumulation buffer to host."""
    return np.asarray(jax.device_get(accum))


def untile_image(buf: np.ndarray, width: int, height: int, row_shards: int):
    """Convert a sharded, per-shard tile-ordered buffer (H*W, 3) to row-major."""
    from wgpu_path_tracing_tpu.utils.tiling import (
        inverse_permutation,
        tile_permutation,
    )

    local_rows = height // row_shards
    inv = inverse_permutation(tile_permutation(width, local_rows))
    out = buf.reshape(row_shards, local_rows * width, 3)[:, inv]
    return out.reshape(height * width, 3)
