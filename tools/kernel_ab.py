"""GPU A/B of the intersection kernels against what XLA makes of the plain
references, by profiler device time, in one warm process.

    python tools/kernel_ab.py [--out chiprun_out/kernel_ab.jsonl]

Per scene and ray batch (262,144 coherent camera rays and as many
incoherent scene rays):

* ``dense``: ops/pallas_kernels.py::closest_hit_dense against
  ops/intersect.py::closest_hit_brute;
* ``bvh``: closest_hit_bvh_kernel against closest_hit_bvh_linked, closest
  hit and shadow-style any-hit (t_max, half the lanes active);
* the dense/BVH crossover: both kernels on scenes from 36 to 12k
  triangles;
* block-size sweeps of both kernels.

Every line names the card (``nvidia-smi`` name and power limit). Needs a
GPU: it exits non-zero on any other backend.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wgpu_path_tracing_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wgpu_path_tracing_tpu.models.procedural import cornell_box  # noqa: E402
from wgpu_path_tracing_tpu.models.types import pack_device_scene  # noqa: E402
from wgpu_path_tracing_tpu.ops import intersect as I  # noqa: E402
from wgpu_path_tracing_tpu.ops import pallas_kernels as K  # noqa: E402
from wgpu_path_tracing_tpu.utils import devtrace  # noqa: E402
from wgpu_path_tracing_tpu.utils.rays import camera_rays, scene_rays  # noqa: E402

N_RAYS = 512 * 512
REPS = 3


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_ms(fn, reps: int = REPS) -> float:
    """Warm ``fn`` (returns arrays), then device busy ms per call."""
    jax.block_until_ready(fn())
    events = devtrace.trace_device(
        lambda: jax.block_until_ready([fn() for _ in range(reps)]))
    return devtrace.busy_ms(events) / reps


def ulp_diff(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    both = np.isfinite(a) & np.isfinite(b)
    d = np.abs(a[both].view(np.int32).astype(np.int64)
               - b[both].view(np.int32).astype(np.int64))
    return int(d.max()) if d.size else 0, int((np.isfinite(a) != np.isfinite(b)).sum())


def packed(tess: int):
    sc = pack_device_scene(cornell_box(tessellation=tess))
    dev = jax.device_put(sc)
    nodes = jnp.concatenate([dev["bvh_links"], dev["bvh_meta"][:, 2:4]], 1)
    return sc, dev, nodes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/kernel_ab.jsonl")
    ap.add_argument("--sections", default="crossover,bvh,blocks,render",
                    help="comma-separated subset to run")
    args = ap.parse_args()
    sections = set(args.sections.split(","))
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("kernel_ab.py needs a GPU")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    out = open(args.out, "w")
    base = {"card": card(), "device_kind": jax.devices()[0].device_kind}

    def emit(**kw):
        line = json.dumps({**base, **kw})
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    x = jnp.ones((2048, 2048), jnp.float32)
    jax.block_until_ready(x @ x)
    d = "chiprun_out/trace_describe"
    with jax.profiler.trace(d):
        jax.block_until_ready(x @ x)
    import glob

    for path in glob.glob(d + "/plugins/profile/*/*.xplane.pb"):
        with open(os.path.join(os.path.dirname(args.out), "trace_describe.txt"), "w") as f:
            f.write("\n".join(devtrace.describe(path)))

    cam = [jnp.asarray(a) for a in camera_rays(512, 512)]

    # Dense kernel vs XLA brute, and the dense/BVH crossover.
    for tess in () if "crossover" not in sections else (1, 2, 3, 4, 5, 6, 8, 10, 19, 55):
        sc, dev, nodes = packed(tess)
        tris = int(sc["tri_isect"].shape[0])
        inc = [jnp.asarray(a) for a in scene_rays(sc["bvh_aabb"], N_RAYS, 1)]
        for kind, (ro, rd) in (("camera", cam), ("scene", inc)):
            row = {"tris": tris, "rays": kind}
            f_bvh_k = lambda: K.closest_hit_bvh_kernel(
                dev["bvh_aabb"], nodes, dev["tri_isect"], ro, rd)
            row["bvh_kernel_ms"] = device_ms(f_bvh_k)
            if tris <= 20000:
                f_k = lambda: K.closest_hit_dense(dev["tri_isect"], ro, rd)
                row["dense_kernel_ms"] = device_ms(f_k)
            if tess in (1, 6, 10, 19):
                f_xla = lambda: I.closest_hit_brute(dev["tri_isect"], ro.T, rd.T)
                t_x, i_x = f_xla()
                t_k, i_k = f_k()
                row["dense_idx_mismatch"] = int((np.asarray(i_x) != np.asarray(i_k)).sum())
                row["dense_t_max_ulp"], row["dense_finite_flips"] = ulp_diff(t_x, t_k)
                row["dense_xla_ms"] = device_ms(f_xla)
            emit(section="dense_crossover", **row)

    # BVH kernel vs XLA linked walk.
    for tess in (55, 150) if "bvh" in sections else ():
        sc, dev, nodes = packed(tess)
        tris = int(sc["tri_isect"].shape[0])
        inc = [jnp.asarray(a) for a in scene_rays(sc["bvh_aabb"], N_RAYS, 2)]
        rng = np.random.default_rng(3)
        active = jnp.asarray(rng.uniform(size=N_RAYS) < 0.5)
        t_max = jnp.asarray(rng.uniform(0.05, 2.0, N_RAYS).astype(np.float32))
        for kind, (ro, rd) in (("camera", cam), ("scene", inc)):
            for any_hit in (False, True):
                kw = dict(active=active, t_max=t_max, any_hit=True) if any_hit else {}
                f_x = lambda: I.closest_hit_bvh_linked(
                    dev["bvh_aabb"], nodes, dev["tri_isect"], ro.T, rd.T, **kw)
                f_k = lambda: K.closest_hit_bvh_kernel(
                    dev["bvh_aabb"], nodes, dev["tri_isect"], ro, rd, **kw)
                t_x, i_x = f_x()
                t_k, i_k = f_k()
                row = {"tris": tris, "rays": kind, "any_hit": any_hit,
                       "idx_mismatch": int((np.asarray(i_x) != np.asarray(i_k)).sum())}
                row["t_max_ulp"], row["finite_flips"] = ulp_diff(t_x, t_k)
                row["xla_ms"] = device_ms(f_x, reps=1)
                row["kernel_ms"] = device_ms(f_k)
                emit(section="bvh", **row)

    if "blocks" in sections:
        block_sweep(emit, cam)
    if "render" in sections:
        render_crossover(emit)
    out.close()


def block_sweep(emit, cam):
    """Block shapes of both kernels (a compile per variant)."""
    sc, dev, nodes = packed(55)
    inc = [jnp.asarray(a) for a in scene_rays(sc["bvh_aabb"], N_RAYS, 4)]
    for rays_, warps in ((32, 1), (64, 1), (64, 2), (128, 4)):
        K.BVH_RAYS, K.BVH_WARPS = rays_, warps
        jax.clear_caches()
        ms = device_ms(lambda: K.closest_hit_bvh_kernel(
            dev["bvh_aabb"], nodes, dev["tri_isect"], *inc))
        emit(section="bvh_blocks", block_rays=rays_, warps=warps, tris=102850,
             kernel_ms=ms)
    K.BVH_RAYS, K.BVH_WARPS = 32, 1
    sc1, dev1, _ = packed(10)
    for bn, bt, warps in ((128, 16, 4), (128, 8, 4), (64, 16, 2),
                          (256, 16, 8), (128, 16, 2), (64, 8, 2)):
        K.DENSE_RAYS, K.DENSE_TRIS, K.DENSE_WARPS = bn, bt, warps
        jax.clear_caches()
        for tess_dev, name in ((dev1, "3684"), (jax.device_put(pack_device_scene(cornell_box())), "36")):
            ms = device_ms(lambda: K.closest_hit_dense(tess_dev["tri_isect"], *cam))
            emit(section="dense_blocks", block_rays=bn, block_tris=bt,
                 warps=warps, tris=name, kernel_ms=ms)
    K.DENSE_RAYS, K.DENSE_TRIS, K.DENSE_WARPS = 128, 16, 4
    jax.clear_caches()


def render_crossover(emit):
    """End to end: a 512x512 16-spp render chunk forced through the dense
    and the BVH path, on scenes around the kernel-level crossover."""
    from wgpu_path_tracing_tpu import Renderer, RenderConfig

    for tess in (2, 3, 4, 5, 6, 8):
        scene = cornell_box(tessellation=tess)
        for isect in ("brute", "bvh"):
            r = Renderer(RenderConfig(width=512, height=512,
                                      frames_per_chunk=16, intersector=isect))
            r.load_scene(scene)

            def chunk():
                r.render(spp=16, fetch=False)
                return []

            emit(section="render_crossover", tris=scene.num_triangles,
                 intersector=r.stats()["intersector"],
                 busy_ms_per_16spp_chunk=device_ms(chunk, reps=2))


if __name__ == "__main__":
    main()
