"""The XLA bounce loop (ops/trace.py) — the only bounce implementation —
against the scalar oracle (tests/oracle.py) on each scene variant: the
intersector "auto" picks (dense or threaded BVH), textured atlases
(per-slot and fat), glass and metal lobes, MIS off, fewer bounces, and
the bounce-0 low-discrepancy override."""

import jax
import numpy as np
import pytest

from wgpu_path_tracing_tpu.models.procedural import (
    cornell_box,
    material_test_box,
    textured_cornell,
)
from wgpu_path_tracing_tpu.models.types import pack_device_scene

from tests.oracle import trace_vs_oracle

SIZE = 16


def _per_slot_textured():
    import wgpu_path_tracing_tpu.models.types as MT

    saved = MT.FAT_ATLAS_MAX_TEXELS
    try:
        MT.FAT_ATLAS_MAX_TEXELS = 0
        sc = textured_cornell(atlas_size=64)
        packed = pack_device_scene(sc)
    finally:
        MT.FAT_ATLAS_MAX_TEXELS = saved
    assert "atlas_fat" not in packed
    return sc, packed


VARIANTS = {
    "cornell": (lambda: cornell_box(), {}),
    "cornell_bvh": (lambda: cornell_box(tessellation=5), {}),  # 852 tris
    "textured_fat": (lambda: textured_cornell(atlas_size=32), {}),
    "textured_per_slot": (_per_slot_textured, {}),
    "glass_metal": (lambda: material_test_box(), {}),
    "mis_off": (lambda: cornell_box(), {"do_mis": False}),
    "three_bounces": (lambda: material_test_box(), {"max_bounces": 3}),
    "bounce0_lds": (lambda: cornell_box(), {"lds": True}),
    "bounce0_lds_glass": (lambda: material_test_box(), {"lds": True}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_xla_bounce_matches_oracle(variant):
    make, kw = VARIANTS[variant]
    built = make()
    sc, packed = built if isinstance(built, tuple) else (built, None)
    if packed is None:
        packed = pack_device_scene(sc)
    flips, off = trace_vs_oracle(sc, jax.device_put(packed), SIZE, **kw)
    assert flips <= 1, f"{flips} RNG schedules diverged from the oracle"
    assert off <= 1, f"{off} state-synced radiances off the oracle"


def test_bounce0_lds_engages():
    """The override changes the traced radiance (it is not a no-op) while
    the oracle, fed the same values, still agrees (variant above)."""
    import jax.numpy as jnp

    from wgpu_path_tracing_tpu.ops import camera_rays as CAM
    from wgpu_path_tracing_tpu.ops import trace as TRACE
    from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit
    from wgpu_path_tracing_tpu.render.camera import Camera
    from wgpu_path_tracing_tpu.render.pipeline import camera_device

    sc = cornell_box()
    dev = jax.device_put(pack_device_scene(sc))
    cam = camera_device(Camera(width=SIZE, height=SIZE).as_pytree(), SIZE, SIZE)
    x, y = CAM.pixel_grid(SIZE, SIZE)
    ro, rd, state = CAM.generate_rays(cam, x, y, jnp.int32(0), use_dof=True)
    ch = make_closest_hit(dev, "auto", 512, 4)
    kw = dict(max_bounces=8, do_mis=True, num_lights=sc.num_lights)
    rad0, st0, _ = TRACE.trace(dev, ch, ro, rd, state, **kw)
    rad1, st1, _ = TRACE.trace(dev, ch, ro, rd, state,
                               lds0=CAM.bounce0_lds(x, y, jnp.int32(0)), **kw)
    assert np.abs(np.asarray(rad0) - np.asarray(rad1)).max() > 0.0
