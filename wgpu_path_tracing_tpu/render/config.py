"""Runtime configuration.

The reference hardcodes all of these as compile-time constants scattered
across files (see SURVEY.md §5 "Config / flag system"); here they are promoted
to a real config object:

* ``max_bounces`` — pt.wgsl:5 (MAX_BOUNCES = 8)
* ``do_mis`` — pt.wgsl:636 (DO_MIS = true)
* ``firefly_clamp`` — pt.wgsl:751 (min(trace(ray), vec3f(2.5)))
* ``exposure`` — blit.wgsl:43 (EXPOSURE = 1.0, applied as ×exp2(EXPOSURE))
* ``texture_pixel_ratio`` — atlas.ts:10 (0.5× texture downscale)
* ``move_speed`` / ``rotate_speed`` — controller.ts:3-4
* ``max_leaf_size`` / ``num_bins`` — bvh.ts:42-45 (BuildOptions defaults 4 / 12)
* ``max_frames`` — renderer.ts:16 (MAX_FRAMES = -1, unlimited)

Execution knobs (no reference equivalent):

* ``rng`` — "reference" reproduces random.wgsl's per-pixel PCG stream
  including its conditional draw schedule; "hash" is a statistically stronger
  counter-based mode (decorrelated across draws) for production renders;
  "stratified" additionally draws PRIMARY-ray decisions (pixel jitter, lens
  disc) from a per-pixel-rotated R2 low-discrepancy sequence — measurably
  lower error at equal spp on AA edges and DoF blur, bounce decisions
  unchanged ("hash" stream).
* ``intersector`` — "auto" picks dense all-rays×all-triangles for scenes
  of at most ``brute_force_max_tris`` triangles and the threaded-BVH walk
  otherwise (ops/intersect.py::make_closest_hit); "brute" / "bvh" force
  one, "stack" is the CPU oracle.
* ``frames_per_chunk`` — samples accumulated per jit dispatch (scan length).
"""

from __future__ import annotations

import dataclasses
import math

from wgpu_path_tracing_tpu.ops.intersect import INTERSECTORS


@dataclasses.dataclass
class RenderConfig:
    # Image
    width: int = 512
    height: int = 512

    # Path tracing (reference parity constants)
    max_bounces: int = 8
    do_mis: bool = True
    firefly_clamp: float = 2.5
    exposure: float = 1.0
    max_frames: int = -1

    # Scene ingestion
    texture_pixel_ratio: float = 0.5
    # Extension: render KHR spot lights instead of the reference's
    # warn-and-skip (gpu.ts:234-236). Off by default for parity.
    spot_lights: bool = False

    # BVH build (bvh.ts BuildOptions)
    max_leaf_size: int = 4
    num_bins: int = 12

    # Interaction (controller.ts)
    move_speed: float = 2.0
    rotate_speed: float = math.pi / 18

    # Execution
    rng: str = "reference"  # "reference" | "hash" | "stratified"
    intersector: str = "auto"  # "auto" | "brute" | "bvh" | "stack"
    # "auto" dense/BVH crossover, measured end to end on an H100 (PERF.md).
    brute_force_max_tris: int = 384
    frames_per_chunk: int = 16
    # Frames whose rays are batched into ONE trace call per scan step
    # (pipeline.render_chunk): >1 packs F x width*height lanes per
    # intersection call. Accumulation stays per-frame-ordered. The
    # renderer clamps it per chunk with gcd so any spp works.
    frames_per_trace: int = 1
    dtype: str = "float32"

    # Environment lighting EXTENSION (ops/env.py): None keeps reference
    # parity (miss -> black, pt.wgsl:646-649). Path to .hdr/.exr/LDR.
    env_map: str | None = None
    env_intensity: float = 1.0
    env_rotation: float = 0.0  # radians, yaw

    # Debug render modes (ports of pt_bvh.wgsl / pt_debug.wgsl)
    # "pt" (full path trace) | "bvh_depth" | "normal"
    mode: str = "pt"

    def validate(self) -> "RenderConfig":
        assert self.width > 0 and self.height > 0
        assert self.rng in ("reference", "hash", "stratified")
        if self.intersector not in INTERSECTORS:
            raise ValueError(
                f"unknown intersector {self.intersector!r}; expected one "
                f"of {INTERSECTORS}")
        assert self.mode in ("pt", "bvh_depth", "normal")
        assert self.frames_per_trace >= 1
        return self
