"""Smoke test of the renderer on NVIDIA GPUs, through the public API.

    python chip_smoke.py          # phases 1-6 on one card
    python chip_smoke.py --four   # only the sharded render on four cards

Phases (one process, each asserts its checks; any failure exits non-zero):

1. headline: Cornell box 512x512, 128 spp, dense intersector;
2. large scenes: tessellated Cornell (102,850 tris, frames_per_trace=8)
   and the gallery atrium (116k tris, textured), both through "auto" to
   the BVH traversal kernel;
3. scale: tessellated Cornell with 765,002 tris at 128x128 through "auto";
4. textures: textured Cornell with a 512x512 atlas, 16 spp;
5. the compiled kernels against the plain references at real widths;
6. scalar-oracle arbitration of the compiled render path
   (tools/oracle_onchip.py) on the Cornell box and the material box.

``--four`` renders the headline and the 102,850-tri scene with
``Renderer(devices=jax.devices()[:4])`` and compares each with the
one-card image of the same seeds.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed. Without a GPU the script exits non-zero
before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from wgpu_path_tracing_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from wgpu_path_tracing_tpu import (  # noqa: E402
    Renderer,
    RenderConfig,
    cornell_box,
    textured_cornell,
)
from wgpu_path_tracing_tpu.models.gallery import gallery_atrium  # noqa: E402
from wgpu_path_tracing_tpu.models.procedural import random_triangles  # noqa: E402
from wgpu_path_tracing_tpu.models.types import pack_device_scene  # noqa: E402
from wgpu_path_tracing_tpu.ops import intersect as I  # noqa: E402
from wgpu_path_tracing_tpu.ops import pallas_kernels as K  # noqa: E402
from wgpu_path_tracing_tpu.utils.rays import camera_rays, scene_rays  # noqa: E402

# Razor-tie class (ops/intersect.py): two triangles within 1 ulp of t on a
# shared edge; the winner depends on the visit order. Allowed share:
MAX_TIE_SHARE = 0.002
# t may differ by one ulp: FMA contraction differs between the kernel's
# compiler and XLA's fusion of the reference.
MAX_T_ULPS = 1
# Sharded vs one-card HDR buffer, absolute: the same frames with the same
# seeds, so only the accumulation order differs (psum of per-shard sums
# divided once, against the one-card per-frame running mean).
MAX_SHARD_DIFF = 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def ulps(a, b) -> np.ndarray:
    """Per-element ulp distance; a finite/infinite mismatch counts huge."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    d = np.abs(a.view(np.int32).astype(np.int64)
               - b.view(np.int32).astype(np.int64))
    both_inf = ~np.isfinite(a) & ~np.isfinite(b)
    d[both_inf] = 0
    d[np.isfinite(a) != np.isfinite(b)] = 1 << 40
    return d


def compare_hits(label, t_ref, i_ref, t_k, i_k, mask=None):
    t_ref, i_ref, t_k, i_k = map(np.asarray, (t_ref, i_ref, t_k, i_k))
    if mask is not None:
        t_ref, i_ref, t_k, i_k = t_ref[mask], i_ref[mask], t_k[mask], i_k[mask]
    d = ulps(t_ref, t_k)
    ties = (i_ref != i_k)
    share = float(ties.mean()) if ties.size else 0.0
    say(f"  {label}: {ties.sum()}/{ties.size} razor-tie idx flips "
        f"({100 * share:.4f}%), max t diff {int(d.max()) if d.size else 0} ulp")
    check(share <= MAX_TIE_SHARE, f"{label}: tie share {share} too high")
    check(d.size == 0 or int(d.max()) <= MAX_T_ULPS,
          f"{label}: t differs by {int(d.max())} ulp")


def render_phase(label, scene, expect, spp, camera_position=None, **cfg):
    r = Renderer(RenderConfig(**cfg))
    r.load_scene(scene)
    if camera_position is not None:
        r.camera.position = np.asarray(camera_position, np.float32)
    strategy = r.stats()["intersector"]
    check(strategy == expect, f"{label}: intersector {strategy}, want {expect}")
    t0 = time.perf_counter()
    r.render(spp=spp, fetch=False)
    first = time.perf_counter() - t0
    r.reset()
    t0 = time.perf_counter()
    hdr = r.render(spp=spp)
    wall = time.perf_counter() - t0
    st = r.stats()
    img = r.image()
    w, h = r.config.width, r.config.height
    check(hdr.shape == (h, w, 3), f"{label}: HDR shape {hdr.shape}")
    check(bool(np.isfinite(hdr).all()), f"{label}: non-finite HDR values")
    check(float(hdr.mean()) > 1e-3, f"{label}: black image")
    check(img.shape == (h, w, 3) and float(img.max()) > 0.05,
          f"{label}: black display image")
    check(st["rays_closest"] >= spp * w * h,
          f"{label}: {st['rays_closest']} closest rays < {spp} x {w}x{h}")
    say(f"[{label}] intersector={strategy} tris={r.scene.num_triangles} "
        f"{w}x{h} spp={spp}: render {wall:.3f} s, "
        f"{st['mrays_per_sec']:.1f} Mrays/s ({st['rays_total']} rays); "
        f"first call {first:.2f} s = compile ~{max(first - wall, 0):.2f} s "
        f"+ render")
    return r, hdr, wall


def phase_kernels():
    say("[kernels] compiled kernels vs plain references")
    n = 512 * 512
    cam = camera_rays(512, 512)
    for name, sc in (("cornell-36", cornell_box()),
                     ("soup-4096", random_triangles(4096, seed=1))):
        dev = jax.device_put(pack_device_scene(sc))
        check(dev["tri_isect"].shape[0] == sc.num_triangles, name)
        for kind, (ro, rd) in (("camera", cam),
                               ("scene", scene_rays(np.asarray(dev["bvh_aabb"]), n, 5))):
            ro, rd = jnp.asarray(ro), jnp.asarray(rd)
            t_b, i_b = I.closest_hit_brute(dev["tri_isect"], ro.T, rd.T)
            t_k, i_k = K.closest_hit_dense(dev["tri_isect"], ro, rd)
            check(int((np.asarray(i_k) >= 0).sum()) > n // 10, f"{name}: few hits")
            compare_hits(f"dense {name} {kind} {n} rays", t_b, i_b, t_k, i_k)

    sc = pack_device_scene(cornell_box(tessellation=55))
    dev = jax.device_put(sc)
    tris = sc["tri_isect"].shape[0]
    nodes = jnp.concatenate([dev["bvh_links"], dev["bvh_meta"][:, 2:4]], 1)
    m = 8192
    ro, rd = (jnp.asarray(a) for a in scene_rays(sc["bvh_aabb"], m, 7))
    rng = np.random.default_rng(8)
    t_max = jnp.asarray(rng.uniform(0.05, 2.0, m).astype(np.float32))
    active = rng.uniform(size=m) < 0.6
    t_b, i_b = I.closest_hit_brute(dev["tri_isect"], ro.T, rd.T)
    bvh = lambda **kw: K.closest_hit_bvh_kernel(
        dev["bvh_aabb"], nodes, dev["tri_isect"], ro, rd, **kw)
    t_k, i_k = bvh()
    check(int((np.asarray(i_k) >= 0).sum()) > m // 2, "bvh: few hits")
    compare_hits(f"bvh closest {m} rays of {tris} tris", t_b, i_b, t_k, i_k)
    t_a, _ = bvh(t_max=t_max, any_hit=True)
    found_ref = np.asarray(t_b) < np.asarray(t_max)
    found = np.asarray(t_a) < np.asarray(t_max)
    flips = float((found != found_ref).mean())
    say(f"  bvh any-hit t_max: {int((found != found_ref).sum())}/{m} "
        f"occlusion flips, {int(found.sum())} occluded")
    check(flips <= MAX_TIE_SHARE, f"bvh any-hit flips {flips}")
    t_c, i_c = bvh(active=jnp.asarray(active))
    check(bool((np.asarray(i_c)[~active] == -1).all())
          and bool(np.isinf(np.asarray(t_c)[~active]).all()),
          "bvh active: inactive lanes reported hits")
    compare_hits("bvh active-mask lanes", t_b, i_b, t_c, i_c, mask=active)
    ro, rd = (jnp.asarray(a) for a in scene_rays(sc["bvh_aabb"], n, 9))
    t_l, i_l = I.closest_hit_bvh_linked(
        dev["bvh_aabb"], nodes, dev["tri_isect"], ro.T, rd.T)
    t_k, i_k = K.closest_hit_bvh_kernel(
        dev["bvh_aabb"], nodes, dev["tri_isect"], ro, rd)
    compare_hits(f"bvh vs XLA threaded walk {n} rays", t_l, i_l, t_k, i_k)


def phase_oracle():
    import oracle_onchip

    for scene in ("cornell", "material"):
        res = oracle_onchip.arbitrate(scene, size=16, quiet=True)
        say(f"[oracle] {scene} intersector={res['intersector']}: razor-tie "
            f"state-flip rate {res['state_flip_rate']:.4f} "
            f"({res['pixels']} pixels), {res['value_mismatch']} synced "
            f"pixels off the oracle")
        check(res["ok"], f"oracle arbitration failed on {scene}: {res}")


FOUR_CASES = (
    ("headline", lambda: cornell_box(), 128,
     dict(width=512, height=512, frames_per_chunk=128)),
    ("large-100k", lambda: cornell_box(tessellation=55), 8,
     dict(width=512, height=512, frames_per_chunk=8, frames_per_trace=8)),
)


def phase_four():
    devices = jax.devices()
    check(len(devices) >= 4, f"--four needs 4 GPUs, found {len(devices)}")
    for label, make_scene, spp, cfg in FOUR_CASES:
        scene = make_scene()
        _, single, t1 = render_phase(f"four/{label}/1-card", scene,
                                     _expect(scene), spp, **cfg)
        r4 = Renderer(RenderConfig(**cfg), devices=devices[:4])
        r4.load_scene(scene)
        r4.render(spp=spp, fetch=False)
        r4.reset()
        t0 = time.perf_counter()
        multi = r4.render(spp=spp)
        t4 = time.perf_counter() - t0
        diff = float(np.abs(multi - single).max())
        say(f"[four/{label}] mesh={dict(r4.mesh.shape)} shard_map "
            f"{t4:.3f} s vs one card {t1:.3f} s; max |HDR diff| {diff:.3g}")
        check(diff <= MAX_SHARD_DIFF,
              f"{label}: sharded image differs by {diff} > {MAX_SHARD_DIFF}")


def _expect(scene) -> str:
    dense = scene.num_triangles <= RenderConfig().brute_force_max_tris
    return "dense_kernel" if dense else "bvh_kernel"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded render phase")
    args = ap.parse_args()
    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
              f"{dev0.platform}", file=sys.stderr)
        return 1
    say(card())
    say(f"jax {jax.__version__}: {len(jax.devices())} x {dev0.device_kind}")

    if args.four:
        phase_four()
    else:
        render_phase("headline", cornell_box(), "dense_kernel", 128,
                     width=512, height=512, frames_per_chunk=128)
        render_phase("large-100k", cornell_box(tessellation=55),
                     "bvh_kernel", 8, width=512, height=512,
                     frames_per_chunk=8, frames_per_trace=8)
        render_phase("gallery-atrium", gallery_atrium(), "bvh_kernel", 8,
                     camera_position=(0.0, 2.4, 3.0), width=512, height=512,
                     frames_per_chunk=8, frames_per_trace=8)
        render_phase("scale-765k", cornell_box(tessellation=150),
                     "bvh_kernel", 8, width=128, height=128,
                     frames_per_chunk=8, frames_per_trace=8)
        render_phase("textures", textured_cornell(atlas_size=512),
                     "dense_kernel", 16, width=512, height=512,
                     frames_per_chunk=16)
        phase_kernels()
        phase_oracle()

    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": dev0.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
