"""Scalar-oracle arbitration of the compiled render path on the default
backend.

CPU test suites cannot see what the accelerator's compiler does to the
arithmetic (FMA contraction, reduction order, TF32 matrix products). This
tool renders one frame-0 tile through the production path — the XLA
bounce loop (ops/trace.py) with the intersector ``auto`` selects, compiled
for whatever backend is default — and checks EVERY pixel of the tile
against the scalar oracle (tests/oracle.py, pure NumPy, backend-free):

* ``state_flip_rate``: share of pixels whose final RNG state differs from
  the oracle's — the pixel took another branch somewhere (a razor-tie:
  two triangles within an ulp of t, a Russian-roulette or occlusion test
  on the knife edge). Expected to be a few %; reported as the baseline.
* ``value_mismatch``: state-synced pixels whose radiance is off the oracle
  beyond 2e-3. A knife-edge shadow-ray occlusion flips radiance without
  consuming randomness, so a few are expected; a systematic skew (a
  truncated matrix product, a wrong lowering) moves most of them.

Usage:
    python tools/oracle_onchip.py [cornell|material|path.glb] [--size 16]

Exit code 0 when the flip rate is at most ``MAX_FLIP_RATE`` and at most
``MAX_VALUE_MISMATCH`` of the synced pixels are off the oracle.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np

MAX_FLIP_RATE = 0.10
MAX_VALUE_MISMATCH = 0.05


def arbitrate(scene_name: str = "cornell", size: int = 16,
              quiet: bool = False) -> dict:
    """Returns {"ok", "scene", "intersector", "pixels", "state_flip_rate",
    "value_mismatch", "value_mismatch_rate"}."""

    def say(*a):
        if not quiet:
            print(*a, flush=True)

    import importlib.util

    import jax.numpy as jnp

    # Loaded by path: an installed top-level ``tests`` package elsewhere
    # would shadow this repository's tests/ directory.
    spec = importlib.util.spec_from_file_location(
        "wpt_scalar_oracle", os.path.join(ROOT, "tests", "oracle.py"))
    oracle_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle_mod)
    Oracle = oracle_mod.Oracle

    from wgpu_path_tracing_tpu import Renderer, RenderConfig
    from wgpu_path_tracing_tpu.models.procedural import (
        cornell_box,
        material_test_box,
    )
    from wgpu_path_tracing_tpu.ops import camera_rays as CAM
    from wgpu_path_tracing_tpu.ops import trace as TRACE
    from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit
    from wgpu_path_tracing_tpu.render.pipeline import camera_device

    W = H = size
    r = Renderer(RenderConfig(width=W, height=H, frames_per_chunk=1))
    if scene_name == "cornell":
        r.load_scene(cornell_box())
    elif scene_name == "material":
        r.load_scene(material_test_box())
    else:
        r.load_model(scene_name)
    scene, dev = r.scene, r._scene_dev
    cam_dev = camera_device(r.camera.as_pytree(), W, H)
    x, y = CAM.pixel_grid(W, H)
    ro, rd, state = CAM.generate_rays(cam_dev, x, y, jnp.int32(0),
                                      use_dof=True)
    ch = make_closest_hit(dev, "auto", r.config.brute_force_max_tris,
                          r.config.max_leaf_size)
    rad, st, _ = TRACE.trace(dev, ch, ro, rd, state, max_bounces=8,
                             do_mis=True, num_lights=scene.num_lights)
    rad = np.minimum(np.asarray(rad), 2.5)
    st = np.asarray(st)

    c = r.camera
    cam_np = {
        "position": np.asarray(c.position), "forward": np.asarray(c.forward),
        "right": np.asarray(c.right), "up": np.asarray(c.up),
        "fov": np.float32(c.fov), "aspect": np.float32(c.aspect),
        "aperture": np.float32(c.aperture),
        "focus_distance": np.float32(c.focus_distance),
    }
    oracle = Oracle(scene, cam_np, W, H)
    flips = bad = 0
    for lane in range(W * H):
        px, py = lane % W, lane // W
        expected = np.asarray(oracle.render_pixel(px, py, 0), np.float32)
        if int(st[lane]) != int(oracle.rng.state):
            flips += 1
        elif not np.allclose(rad[lane], expected, rtol=2e-3, atol=2e-3):
            bad += 1
            say(f"pixel ({px},{py}): oracle {expected.round(4)} "
                f"got {rad[lane].round(4)}")
    synced = W * H - flips
    res = {
        "scene": scene_name,
        "intersector": ch.strategy,
        "pixels": W * H,
        "state_flip_rate": flips / (W * H),
        "value_mismatch": bad,
        "value_mismatch_rate": bad / max(synced, 1),
    }
    res["ok"] = (res["state_flip_rate"] <= MAX_FLIP_RATE
                 and res["value_mismatch_rate"] <= MAX_VALUE_MISMATCH)
    say(f"{scene_name} [{ch.strategy}]: {flips}/{W * H} razor-tie state "
        f"flips, {bad}/{synced} synced pixels off the oracle -> "
        f"{'PASS' if res['ok'] else 'FAIL'}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="cornell")
    ap.add_argument("--size", type=int, default=16)
    args = ap.parse_args()
    return 0 if arbitrate(args.scene, args.size)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
