"""Jitted progressive render pipeline.

Equivalent of the reference's per-frame dispatch (renderer.ts:415-454): each
"frame" is one sample per pixel, accumulated into an HDR running mean
(pt.wgsl:753-761: output = mix(prev, color, 1/(frameIndex+1)) — at frame 0
the mix weight is 1, which IS the reference's overwrite branch).

``n_frames`` samples are folded into one jit dispatch via
``lax.scan`` with the accumulation buffer donated, so the device never syncs
with the host between samples. Ray counters ride along for Mrays/s metrics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from wgpu_path_tracing_tpu.ops import camera_rays as CAM
from wgpu_path_tracing_tpu.ops import trace as TRACE
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit


def camera_device(cam_pytree: dict, width: int, height: int) -> dict:
    """Extend the dynamic camera pytree with f32 dims (static per pipeline)."""
    cam = dict(cam_pytree)
    cam["width_f"] = jnp.float32(width)
    cam["height_f"] = jnp.float32(height)
    return cam


def make_trace_fn(scene, closest_hit, *, max_bounces: int, do_mis: bool,
                  num_lights: int,
                  slots_used: tuple = (True, True, True, True),
                  rng_mode: str = "reference"):
    """Build the bounce-loop callable (ops/trace.py). Shared by the
    single-device pipeline and the shard_map path."""
    # NEE against zero lights is pure overhead (and the padded zero light
    # row must never be sampled); skip the shadow pass entirely.
    do_mis = bool(do_mis) and num_lights > 0

    # Opt-in bounce-0 low-discrepancy extension (rng="stratified" +
    # CAM.TRACE_BOUNCE0_LDS).
    lds_active = rng_mode == "stratified" and CAM.TRACE_BOUNCE0_LDS

    def trace_fn(ro, rd, state, lds0=None):
        return TRACE.trace(
            scene, closest_hit, ro, rd, state,
            max_bounces=max_bounces, do_mis=do_mis, num_lights=num_lights,
            slots_used=slots_used, lds0=lds0,
        )

    trace_fn.lds_active = lds_active
    return trace_fn


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_frames",
        "width",
        "height",
        "row_offset",
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
        "frames_per_trace",
    ),
    donate_argnames=("accum",),
)
def render_chunk(
    scene,
    cam,
    accum,
    frame_start,
    *,
    n_frames: int,
    width: int,
    height: int,
    row_offset: int = 0,
    use_dof: bool,
    rng_mode: str,
    max_bounces: int,
    do_mis: bool,
    num_lights: int,
    firefly_clamp: float,
    intersector: str,
    brute_max_tris: int,
    leaf_size: int,
    slots_used: tuple = (True, True, True, True),
    frames_per_trace: int = 1,
):
    """Accumulate ``n_frames`` 1-spp frames starting at ``frame_start``.

    accum: (N, 3) HDR running mean (N = width*height rays, TILE-major lane
    order — see utils/tiling.py; un-permute with ``inverse_permutation``
    when reading the image out).
    Returns (accum, counters) with counters = int64 [closest, shadow] rays.

    ``frames_per_trace`` (F > 1, must divide n_frames) batches F frames'
    rays into ONE trace call of F*N lanes per scan step. The RNG draw
    schedule and the per-frame accumulation ORDER are identical to F=1;
    radiance differs only by FMA-placement ulps (the traced shape
    changes, so XLA fuses differently). Default F=1 keeps the parity path
    untouched. The win is amortized per-call fixed cost: wider
    intersection calls. The reference fixes 1 spp per dispatch
    (renderer.ts:415-454)."""
    from wgpu_path_tracing_tpu.utils.tiling import tile_permutation

    x, y = CAM.pixel_grid(width, height, row_offset)
    perm = jnp.asarray(tile_permutation(width, height))
    x = x[perm]
    y = y[perm]
    closest_hit = make_closest_hit(scene, intersector, brute_max_tris, leaf_size)
    trace_fn = make_trace_fn(
        scene, closest_hit,
        max_bounces=max_bounces, do_mis=do_mis, num_lights=num_lights,
        slots_used=slots_used, rng_mode=rng_mode,
    )

    fpt = int(frames_per_trace)
    if fpt < 1 or n_frames % fpt != 0:
        raise ValueError(
            f"frames_per_trace={fpt} must be >= 1 and divide "
            f"n_frames={n_frames}"
        )
    n = x.shape[0]

    def step(carry, k):
        accum, counters = carry
        base = frame_start + k * fpt
        parts = [
            CAM.generate_rays(
                cam, x, y, base + jnp.int32(i), use_dof=use_dof,
                rng_mode=rng_mode,
            )
            for i in range(fpt)
        ]
        if fpt == 1:
            ro, rd, state = parts[0]
        else:
            ro = jnp.concatenate([p[0] for p in parts])
            rd = jnp.concatenate([p[1] for p in parts])
            state = jnp.concatenate([p[2] for p in parts])
        lds0 = None
        if trace_fn.lds_active:
            ldss = [CAM.bounce0_lds(x, y, base + jnp.int32(i))
                    for i in range(fpt)]
            lds0 = ldss[0] if fpt == 1 else jnp.concatenate(ldss, axis=1)
        radiance, state, stats = trace_fn(ro, rd, state, lds0)
        # Primary rays also count toward throughput metrics.
        counters = counters + jnp.stack([stats["closest"], stats["shadow"]])
        # Running mean (pt.wgsl:753-761), applied PER FRAME in order so
        # the accumulator is bit-identical to unbatched frames.
        for i in range(fpt):
            color = jnp.minimum(radiance[i * n : (i + 1) * n],
                                jnp.float32(firefly_clamp))  # pt.wgsl:751
            t = 1.0 / ((base + jnp.int32(i)).astype(jnp.float32) + 1.0)
            accum = accum * (1.0 - t) + color * t
        return (accum, counters), None

    counters0 = jnp.zeros((2,), jnp.int32)
    (accum, counters), _ = jax.lax.scan(
        step, (accum, counters0), jnp.arange(n_frames // fpt, dtype=jnp.int32)
    )
    return accum, counters
