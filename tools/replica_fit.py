"""Fit REPLICA_PARAMS (models/replica.py) against the reference golden.

Coordinate-descent hill climb of the cornell.glb replica's placement and
material parameters, minimizing sRGB RMSE against the reference's own
512-spp golden (docs/img/cornell_512spp.png — the scene that produced it is
stripped from the mirror, see models/replica.py).

Every evaluation keeps IDENTICAL array shapes so the jitted pipeline
compiles once: the scene is padded to a fixed triangle count
(``pad_to=8192``), the intersector is forced to the dense brute kernel
(only ``tri_isect`` feeds it), and the geometry-shaped acceleration tables
(BVH tables — unused under "brute") are replaced by
fixed dummy arrays. The RNG is deterministic per frame index, so RMSE
comparisons between candidates are noise-consistent.

Usage:  python tools/replica_fit.py [rounds] [size] [spp] [step_scale] \
            [seed.json]
Prints the improved REPLICA_PARAMS dict to paste back into replica.py.
``step_scale`` shrinks the initial steps for refinement passes. If a
``seed.json`` path is given, its params override REPLICA_PARAMS as the
starting point, and the best-so-far params are checkpointed back to that
file after every improvement (crash-safe: a killed fit loses at most one
evaluation).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from wgpu_path_tracing_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from golden_rmse import GOLDEN, box_resize, crop_border  # noqa: E402
from wgpu_path_tracing_tpu.models.replica import (  # noqa: E402
    REPLICA_CAMERA_POSITION,
    REPLICA_PARAMS,
    cornell_replica,
)
from wgpu_path_tracing_tpu.models.types import pack_device_scene  # noqa: E402
from wgpu_path_tracing_tpu.render.camera import Camera  # noqa: E402
from wgpu_path_tracing_tpu.render.pipeline import (  # noqa: E402
    camera_device,
    render_chunk,
)
from wgpu_path_tracing_tpu.utils import image as imageio  # noqa: E402
from wgpu_path_tracing_tpu.utils.image import read_png, rmse  # noqa: E402
from wgpu_path_tracing_tpu.utils.tiling import (  # noqa: E402
    inverse_permutation,
    tile_permutation,
)

PAD_TO = 8192

# Fixed-shape stand-ins for the accel tables the brute intersector never
# touches (their true shapes depend on the BVH structure, which changes
# with every geometry tweak and would force a recompile).
_DUMMY_TABLES = {
    "bvh_aabb": np.zeros((1, 6), np.float32),
    "bvh_meta": np.zeros((1, 4), np.int32),
    "bvh_links": np.full((1, 2), -1, np.int32),
}

# (param, initial step); geometry in world units, colors in linear sRGB.
FIT_SPEC = [
    ("fig_cx", 0.05), ("fig_cz", 0.05),
    ("fig_base_w", 0.06), ("fig_base_d", 0.06), ("fig_base_h", 0.02),
    ("fig_body_r", 0.03), ("fig_head_r", 0.02),
    ("brown_r", 0.08), ("brown_g", 0.05), ("brown_b", 0.04),
    ("base_r", 0.05), ("base_g", 0.05), ("base_b", 0.05),
    ("body_r", 0.05), ("body_g", 0.05), ("body_b", 0.05),
    ("monkey_cx", 0.05), ("monkey_cz", 0.05), ("monkey_s", 0.05),
    ("chrome_cx", 0.05), ("chrome_cz", 0.05), ("chrome_r", 0.02),
    ("cube_cx", 0.04), ("cube_cz", 0.04), ("cube_s", 0.03), ("cube_yaw", 7.0),
    ("ped_cx", 0.04), ("ped_cz", 0.04), ("ped_w", 0.04), ("ped_h", 0.03),
    ("glass1_r", 0.02), ("glass2_r", 0.015),
    ("light_strength", 1.2),
    ("wood_stave_amp", 0.06), ("wood_ring_amp", 0.1),
    ("wood_band_dark", 0.12), ("wood_band_y", 0.06), ("wood_band_h", 0.05),
    ("wood_band_g", 0.05),
    ("q_amp", 0.08), ("body_sy", 0.08),
]

# Hard parameter bounds: the coordinate descent must not "improve" RMSE
# by deleting objects the golden visibly contains (it drove chrome_r
# toward 0 twice — the few mismatched pixels cost less than a mismatched
# reflection, but an absent ball is a wrong scene).
BOUNDS = {
    "wood_stave_amp": (0.0, 0.8), "wood_ring_amp": (0.0, 0.9),
    "wood_band_dark": (0.0, 0.9), "wood_band_y": (0.1, 0.9),
    "wood_band_h": (0.02, 0.5), "wood_band_g": (0.0, 0.4),
    # The golden's chrome ball is prominent (~0.07 radius measured off
    # the zoom); keep the fit from deleting it OR ballooning it.
    "chrome_r": (0.04, 0.12),
    "q_amp": (0.0, 0.6),
    "body_sy": (1.0, 1.6),
    "brown_r": (0.0, 1.0), "brown_g": (0.0, 1.0), "brown_b": (0.0, 1.0),
    "base_r": (0.0, 1.0), "base_g": (0.0, 1.0), "base_b": (0.0, 1.0),
    "body_r": (0.0, 1.0), "body_g": (0.0, 1.0), "body_b": (0.0, 1.0),
    "glass1_r": (0.05, 0.4),
    "glass2_r": (0.04, 0.3),
    "fig_body_r": (0.08, 0.4),
    "fig_head_r": (0.08, 0.4),
    "monkey_s": (0.1, 0.6),
    "light_strength": (5.0, 40.0),
}


def make_eval(size: int, spp: int):
    w = h = size
    golden = crop_border(read_png(GOLDEN))
    golden = box_resize(golden, h, w)
    cam = Camera(width=w, height=h)
    cam.position[:] = REPLICA_CAMERA_POSITION
    cam_dev = camera_device(cam.as_pytree(), w, h)
    perm = tile_permutation(w, h)
    inv = inverse_permutation(perm)

    def evaluate(overrides: dict) -> float:
        sc = cornell_replica(pad_to=PAD_TO, overrides=overrides)
        dev = pack_device_scene(sc)
        dev.update(_DUMMY_TABLES)
        dev = {k: jnp.asarray(v) for k, v in dev.items()}
        accum = jnp.zeros((w * h, 3), jnp.float32)
        accum, _ = render_chunk(
            dev, cam_dev, accum, jnp.int32(0),
            n_frames=spp, width=w, height=h, use_dof=True,
            rng_mode="reference", max_bounces=8, do_mis=True,
            num_lights=sc.num_lights, firefly_clamp=2.5,
            intersector="brute", brute_max_tris=PAD_TO, leaf_size=4,
        )
        srgb = imageio.buffer_to_srgb(np.asarray(accum)[inv], w, h, 1.0)
        return float(rmse(srgb, golden))

    return evaluate


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 192
    spp = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    scale = float(sys.argv[4]) if len(sys.argv) > 4 else 1.0
    ckpt = sys.argv[5] if len(sys.argv) > 5 else None
    evaluate = make_eval(size, spp)

    best = dict(REPLICA_PARAMS)
    if ckpt and os.path.exists(ckpt):
        with open(ckpt) as f:
            best.update({k: v for k, v in json.load(f).items()
                         if not k.startswith("_")})
        print(f"seeded {ckpt}", flush=True)
    t0 = time.time()
    cur = evaluate(best)
    print(f"start rmse={cur:.4f} ({time.time() - t0:.1f}s first eval)",
          flush=True)

    steps = {k: v * scale for k, v in FIT_SPEC}
    for rnd in range(rounds):
        improved = False
        for name, _ in FIT_SPEC:
            d = steps[name]
            for cand_d in (d, -d):
                cand = dict(best)
                cand[name] = best[name] + cand_d
                lo, hi = BOUNDS.get(name, (None, None))
                if lo is not None and cand[name] < lo:
                    cand[name] = lo
                if hi is not None and cand[name] > hi:
                    cand[name] = hi
                if cand[name] == best[name]:
                    continue
                v = evaluate(cand)
                if v < cur - 1e-5:
                    best, cur = cand, v
                    improved = True
                    print(f"  [{rnd}] {name} {cand[name]:+.4f} -> "
                          f"rmse={cur:.4f}", flush=True)
                    if ckpt:
                        with open(ckpt, "w") as f:
                            json.dump({**best, "_rmse": cur}, f, indent=1)
                    break
            else:
                steps[name] = d * 0.5
        print(f"round {rnd}: rmse={cur:.4f} ({time.time() - t0:.0f}s)",
              flush=True)
        if not improved:
            break

    changed = {k: round(v, 4) for k, v in best.items()
               if abs(v - REPLICA_PARAMS[k]) > 1e-9}
    print(f"final rmse={cur:.4f}; changed params:\n{changed}")


if __name__ == "__main__":
    main()
