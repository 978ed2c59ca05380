"""Benchmark runner — one JSON line per config, headline last.

The reference publishes no numbers, so ``vs_baseline`` on the HEADLINE
line (Cornell 512x512, 512 spp, full MIS+NEE — printed LAST so a
single-line parse picks it up) compares against a fixed
browser-WebGPU-class anchor of 100 Mrays/s. Configs:

1. cornell-128-nomis      Cornell, 128x128, 8 spp, no MIS (diffuse-path only)
2. cornell-512-mis        Cornell, 512x512, 64 spp, full BSDF + MIS/NEE
3. textured-cornell       synthetic atlas (checker albedo/PBR/normal maps)
4. glass-dof              material box (glass, GGX metal, point/directional
                          lights) with depth of field
5. large-100k             tessellated Cornell, 102,852 tris (BVH traversal)
6. textured-512atlas      512x512 texel atlas: fat-atlas variants and the
                          per-slot gather fallback
7. large-765k             765k tris, plus 2M and ~4M points, all "auto"
8. quality-dof-denoise    display-space RMSE at 16 spp raw vs denoised
                          (ops/denoise.py) vs adaptive (render/adaptive.py)
9. interactive-256        motion-to-fresh-frame latency and sustained
                          pipelined FPS at 256^2 (the reference's rAF loop,
                          renderer.ts:456-473)
10. shard-tax             render_chunk_sharded on a 1-device mesh vs
                          render_chunk on the same device (headline + large)
11. oracle-parity         scalar-oracle arbitration of the compiled render
                          path (tools/oracle_onchip.py), cornell + material
12. gallery-atrium        ~116k-tri textured atrium (models/gallery.py)

Every line names the device (platform, kind, count) and the card
(``nvidia-smi`` name and power limit). Device-busy numbers come from the
profiler trace's GPU device plane (utils/devtrace.py); the runner fails
rather than report them from a trace without one. Select configs with
BENCH_CONFIGS=1,3 (env) when iterating.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np

from wgpu_path_tracing_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

BASELINE_MRAYS = 100.0  # browser-WebGPU-class anchor (no published numbers)
MIN_SECONDS = 2.0  # repeat tiny configs until the wall clock is trustworthy


def _bench_renderer(r, spp: int, warmup_spp: int | None = None):
    """Warm up (compile), then time repeated renders of ``spp``.

    fetch=False skips the per-rep full-image pull (the reference never
    reads its GPU buffer back either); timing stays honest via the
    end-of-render counter sync, and the image is pulled + NaN-checked once
    after the clock stops."""
    r.render(spp=warmup_spp or spp)
    r.reset()
    reps = 0
    rays = 0
    t0 = time.perf_counter()
    while True:
        r.render(spp=spp, fetch=False)
        reps += 1
        rays += r.stats()["rays_total"]
        elapsed = time.perf_counter() - t0
        if elapsed >= MIN_SECONDS or reps >= 16:
            break
        r.reset()
    img = r.image()
    assert not np.isnan(img).any()
    return rays / elapsed / 1e6, elapsed / reps, rays


def _bench_sustained(r, spp: int, reps: int = 32):
    """Sustained interactive throughput: ``reps`` pipelined ``spp``-chunks
    with NO per-call host sync (render(sync=False)), one counter pull at
    the end — the reference's rAF loop never blocks on the GPU either
    (renderer.ts:456-473)."""
    for _ in range(reps):  # warm: the chunk program and the counter stack
        r.render(spp=spp, fetch=False, sync=False)
    before = r.stats()["rays_total"]
    t0 = time.perf_counter()
    for _ in range(reps):
        r.render(spp=spp, fetch=False, sync=False)
    rays = r.stats()["rays_total"] - before  # stats() syncs the chain
    elapsed = time.perf_counter() - t0
    img = r.image()
    assert not np.isnan(img).any()
    return rays / elapsed / 1e6, elapsed / reps, rays


def _device_busy_ms(run_once, reps: int):
    """Device busy ms per invocation of ``run_once`` (which must END
    SYNCED): a warm pass first, then a traced pass whose GPU device-plane
    intervals are merged (utils/devtrace.py). Raises when the trace holds
    no device events."""
    from wgpu_path_tracing_tpu.utils import devtrace

    run_once(reps)  # warm: compiles land outside the trace
    events = devtrace.trace_device(lambda: run_once(reps))
    return devtrace.busy_ms(events) / reps


def _device_fields():
    import jax

    d = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        card = None
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "card": card}


def _emit(name, mrays, wall, rays, spp, extra=None):
    line = {
        "metric": "mrays_per_sec",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
        "scene": name,
        "spp": spp,
        "wall_clock_s": round(wall, 3),
        "rays_total": rays,
        **DEVICE,
    }
    if extra:
        line.update(extra)
    print(json.dumps(line), flush=True)
    return line


def _line(**fields):
    print(json.dumps({**fields, **DEVICE}), flush=True)


DEVICE: dict = {}


def main():
    import jax

    from wgpu_path_tracing_tpu import (
        Renderer,
        RenderConfig,
        cornell_box,
        textured_cornell,
    )
    from wgpu_path_tracing_tpu.models.procedural import material_test_box

    DEVICE.update(_device_fields())
    sel = os.environ.get("BENCH_CONFIGS",
                         "1,2,3,4,5,6,7,8,9,10,11,12,headline")
    sel = {s.strip() for s in sel.split(",")}

    if "1" in sel:
        # frames_per_trace=8: a 128^2 trace call is only 16k lanes;
        # batching the chunk's 8 frames makes one 131k-lane call.
        r = Renderer(RenderConfig(width=128, height=128, frames_per_chunk=8,
                                  do_mis=False, frames_per_trace=8))
        r.load_scene(cornell_box())
        mrays0, wall0, _ = _bench_renderer(r, spp=8)
        mrays, wall, rays = _bench_sustained(r, spp=8)

        def _run1(reps):
            for _ in range(reps):
                r.render(spp=8, fetch=False, sync=False)
            r.stats()  # syncs the chain

        busy = _device_busy_ms(_run1, 16)
        _line(metric="device_busy_ms_per_chunk", value=round(busy, 3),
              unit="ms per 8-spp chunk (profiler, merged device intervals)",
              vs_baseline=round(mrays / BASELINE_MRAYS, 3),
              scene="cornell-128-nomis", spp=8,
              sustained_mrays=round(mrays, 3),
              sustained_wall_s=round(wall, 3), rays_total=rays,
              from_scratch_mrays=round(mrays0, 3),
              from_scratch_wall_s=round(wall0, 3))

    if "2" in sel:
        r = Renderer(RenderConfig(width=512, height=512, frames_per_chunk=64))
        r.load_scene(cornell_box())
        mrays, wall, rays = _bench_renderer(r, spp=64)
        _emit("cornell-512-mis", mrays, wall, rays, 64)

    if "3" in sel:
        r = Renderer(RenderConfig(width=512, height=512, frames_per_chunk=64))
        r.load_scene(textured_cornell())
        mrays, wall, rays = _bench_renderer(r, spp=64)
        _emit("textured-cornell", mrays, wall, rays, 64)

    if "4" in sel:
        r = Renderer(RenderConfig(width=512, height=512, frames_per_chunk=32,
                                  frames_per_trace=4))
        r.load_scene(material_test_box())
        r.camera.aperture = 0.05  # real depth of field
        mrays, wall, rays = _bench_renderer(r, spp=32)
        _emit("glass-dof", mrays, wall, rays, 32,
              {"tris": r.scene.num_triangles,
               "intersector": r.stats()["intersector"],
               "env_lighting": "waived (parity: miss->black)"})

    if "5" in sel:
        r = Renderer(RenderConfig(width=512, height=512, frames_per_chunk=8,
                                  frames_per_trace=8))
        r.load_scene(cornell_box(tessellation=55))  # 102,852 tris
        mrays, wall, rays = _bench_renderer(r, spp=8, warmup_spp=8)
        _emit("large-100k", mrays, wall, rays, 8,
              {"tris": r.scene.num_triangles,
               "intersector": r.stats()["intersector"]})

    if "6" in sel:
        import wgpu_path_tracing_tpu.models.types as MT

        def _atlas_run(scene, fat: bool):
            r = Renderer(RenderConfig(width=512, height=512,
                                      frames_per_chunk=64))
            r.load_scene(scene)
            assert ("atlas_fat" in r._scene_dev) == fat
            return _bench_renderer(r, spp=64)

        # Congruent map set: one fat-atlas row fetch serves all 4 slots.
        mrays, wall, rays = _atlas_run(
            textured_cornell(atlas_size=512, congruent=True), True)
        # Mixed per-slot resolutions (albedo a/2, pbr a/4).
        mrays2, _, _ = _atlas_run(textured_cornell(atlas_size=512), True)
        # Non-divisible map set: LCM virtual rects.
        sc3 = textured_cornell(atlas_size=512)
        sc3.mat_pbr_rect[0] = [256, 0, 96, 96]
        mrays3, _, _ = _atlas_run(sc3, True)
        # Tiled uvs (non-negative, past 1.0).
        sc5 = textured_cornell(atlas_size=512, congruent=True)
        for uv in (sc5.tri_uv0, sc5.tri_uv1, sc5.tri_uv2):
            uv[:] = np.asarray(uv) * 3.0
        mrays5, _, _ = _atlas_run(sc5, True)
        # Negative uvs (doubled grids bake the backward band).
        sc6 = textured_cornell(atlas_size=512, congruent=True)
        sc6.tri_uv0[:] = np.asarray(sc6.tri_uv0) - 1.0
        mrays6, _, _ = _atlas_run(sc6, True)
        # The per-slot gather fallback, forced by zeroing the bake budget.
        budget = MT.FAT_ATLAS_MAX_TEXELS
        try:
            MT.FAT_ATLAS_MAX_TEXELS = 0
            sc4 = textured_cornell(atlas_size=512, congruent=True)
            r4 = Renderer(RenderConfig(width=512, height=512,
                                       frames_per_chunk=64))
            r4.load_scene(sc4)
            assert "atlas_fat" not in r4._scene_dev
        finally:
            MT.FAT_ATLAS_MAX_TEXELS = budget
        mrays4, _, _ = _bench_renderer(r4, spp=64)
        _emit("textured-512atlas", mrays, wall, rays, 64,
              {"atlas": "512x512 fat atlas (congruent)",
               "mixedres_mrays": round(mrays2, 3),
               "nondivisible_mrays": round(mrays3, 3),
               "tileduv_mrays": round(mrays5, 3),
               "neguv_mrays": round(mrays6, 3),
               "perslot_mrays": round(mrays4, 3)})

    if "7" in sel:
        # Scale through "auto" only: 765k, 2M and ~4M triangles.
        def _scale(tess, size, spp):
            r = Renderer(RenderConfig(width=size, height=size,
                                      frames_per_chunk=spp,
                                      frames_per_trace=spp))
            r.load_scene(cornell_box(tessellation=tess))
            return r, _bench_renderer(r, spp=spp, warmup_spp=spp)

        r, (mrays, wall, rays) = _scale(150, 128, 8)  # 765,002 tris
        r2m, (mrays_2m, _, _) = _scale(243, 128, 8)  # 2,007,666 tris
        r4m, (mrays_4m, _, _) = _scale(345, 64, 1)  # ~4.0M tris
        _emit("large-765k", mrays, wall, rays, 8,
              {"tris": r.scene.num_triangles,
               "intersector": r.stats()["intersector"],
               "tris_2m_mrays": round(mrays_2m, 3),
               "tris_2m_tris": r2m.scene.num_triangles,
               "tris_2m_intersector": r2m.stats()["intersector"],
               "tris_4m_mrays": round(mrays_4m, 3),
               "tris_4m_tris": r4m.scene.num_triangles,
               "tris_4m_intersector": r4m.stats()["intersector"]})

    if "8" in sel:
        # Equal-quality basis: DoF-noise Cornell (aperture 0.25, same
        # compile shapes as config 2); display-space RMSE vs a 768-spp
        # self-golden.
        from wgpu_path_tracing_tpu.utils.image import buffer_to_srgb

        def _srgb(hdr):
            return buffer_to_srgb(hdr.reshape(-1, 3), 512, 512, 1.0)

        def _rmse(a, b):
            return float(np.sqrt(np.mean((a - b) ** 2)))

        def _mk():
            rq = Renderer(RenderConfig(width=512, height=512,
                                       frames_per_chunk=64))
            rq.load_scene(cornell_box())
            rq.camera.aperture = 0.25
            return rq

        rg = _mk()
        rg.render(spp=768, fetch=False)
        golden = _srgb(rg._row_major(rg._accum))

        ru = _mk()
        ru.render(spp=16, fetch=False)
        raw_hdr = ru._row_major(ru._accum).reshape(512, 512, 3)
        rmse_raw = _rmse(_srgb(raw_hdr), golden)
        rmse_dn = _rmse(_srgb(ru.denoise()), golden)

        ra = _mk()
        ada_hdr = ra.render_adaptive(16)
        rmse_ada = _rmse(_srgb(ada_hdr), golden)
        rmse_ada_dn = _rmse(_srgb(ra.denoise(hdr=ada_hdr)), golden)

        # raw RMSE scales ~a/sqrt(spp) until convergence; fit a from two
        # raw points to estimate the uniform spp matching the best
        # extension pipeline.
        r64 = _mk()
        r64.render(spp=64, fetch=False)
        rmse_raw64 = _rmse(_srgb(r64._row_major(r64._accum)), golden)
        a_fit = float(np.sqrt(16.0) * rmse_raw
                      + np.sqrt(64.0) * rmse_raw64) / 2.0
        best = min(rmse_dn, rmse_ada_dn)
        _line(metric="display_rmse_16spp_denoised", value=round(rmse_dn, 5),
              unit="rmse (sRGB, vs 768spp self-golden)",
              vs_baseline=round(rmse_raw / rmse_dn, 3),
              scene="quality-dof-denoise",
              rmse_raw_16spp=round(rmse_raw, 5),
              rmse_adaptive_16spp=round(rmse_ada, 5),
              rmse_adaptive_denoised_16spp=round(rmse_ada_dn, 5),
              rmse_raw_64spp=round(rmse_raw64, 5),
              equal_quality_uniform_spp_estimate=round((a_fit / best) ** 2, 1))

    if "9" in sel:
        # The reference's operating mode is a rAF loop blitting 1 spp per
        # frame (renderer.ts:456-473): (a) motion-to-fresh-frame latency —
        # move_camera resets accumulation, render 1 spp, pull the image;
        # (b) sustained pipelined FPS with no per-call host sync.
        ri = Renderer(RenderConfig(width=256, height=256,
                                   frames_per_chunk=1))
        ri.load_scene(cornell_box())
        ri.render(spp=2)  # compile both the chunk and the image pull
        lats = []
        for i in range(5):
            t0 = time.perf_counter()
            ri.move_camera(0.0, 0.01 * (1 - 2 * (i & 1)), 0.0)
            img = ri.render(spp=1)
            lats.append(time.perf_counter() - t0)
        assert not np.isnan(img).any()
        reps = 64
        for _ in range(reps):  # warm the counter-stack shape
            ri.render(spp=1, fetch=False, sync=False)
        before = ri.stats()["rays_total"]
        t0 = time.perf_counter()
        for _ in range(reps):
            ri.render(spp=1, fetch=False, sync=False)
        rays = ri.stats()["rays_total"] - before  # stats() syncs
        sustained = reps / (time.perf_counter() - t0)

        def _run9(reps_):
            for _ in range(reps_):
                ri.render(spp=1, fetch=False, sync=False)
            ri.stats()

        busy = _device_busy_ms(_run9, 16)
        _line(metric="interactive_device_busy_ms_per_frame",
              value=round(busy, 3),
              unit="ms per 1-spp 256^2 frame (profiler, merged intervals)",
              vs_baseline=round(sustained / 60.0, 3),
              scene="interactive-256", sustained_fps=round(sustained, 1),
              motion_to_frame_ms=round(float(np.median(lats) * 1e3), 1),
              rays_per_frame=int(rays // reps))

    if "10" in sel:
        # Sharding tax: the same workload through render_chunk_sharded on
        # a 1-device mesh vs plain render_chunk.
        taxes = {}
        for name, cfg_kw, scene, spp in (
            ("headline", dict(width=512, height=512, frames_per_chunk=64),
             cornell_box(), 64),
            ("large-100k", dict(width=512, height=512, frames_per_chunk=8,
                                frames_per_trace=8),
             cornell_box(tessellation=55), 8),
        ):
            rA = Renderer(RenderConfig(**cfg_kw))
            rA.load_scene(scene)
            mraysA, _, _ = _bench_renderer(rA, spp=spp, warmup_spp=spp)
            rB = Renderer(RenderConfig(**cfg_kw), devices=jax.devices()[:1])
            rB.load_scene(scene)
            mraysB, _, _ = _bench_renderer(rB, spp=spp, warmup_spp=spp)
            taxes[name] = (mraysA, mraysB)
        _line(metric="sharding_tax",
              value=round(taxes["headline"][1] / taxes["headline"][0], 4),
              unit="sharded/unsharded Mrays ratio (1-device mesh)",
              vs_baseline=1.0, scene="shard-tax",
              headline_unsharded_mrays=round(taxes["headline"][0], 3),
              headline_sharded_mrays=round(taxes["headline"][1], 3),
              large100k_unsharded_mrays=round(taxes["large-100k"][0], 3),
              large100k_sharded_mrays=round(taxes["large-100k"][1], 3),
              large100k_ratio=round(
                  taxes["large-100k"][1] / taxes["large-100k"][0], 4))

    if "11" in sel:
        # The compiled render path against the scalar oracle, every pixel
        # of a 16x16 tile, on the Cornell box and the material box.
        import sys as _sys

        _sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools"))
        import oracle_onchip as _O

        res = {s: _O.arbitrate(s, size=16, quiet=True)
               for s in ("cornell", "material")}
        _line(metric="oracle_parity_ok",
              value=int(all(v["ok"] for v in res.values())),
              unit="bool (scalar-oracle arbitration, 16x16 tile)",
              vs_baseline=1.0, scene="oracle-parity",
              **{f"{s}_{k}": v[k] for s, v in res.items()
                 for k in ("state_flip_rate", "value_mismatch",
                           "intersector")})
        for s, v in res.items():
            assert v["ok"], f"oracle arbitration FAILED ({s}): {v}"

    if "12" in sel:
        # Sponza stand-in (models/gallery.py): ~116k tris, 12 materials
        # over 7 texture map sets, several area lights.
        from wgpu_path_tracing_tpu.models.gallery import gallery_atrium

        rg = Renderer(RenderConfig(width=512, height=512,
                                   frames_per_chunk=8, frames_per_trace=8))
        rg.load_scene(gallery_atrium())
        rg.camera.position = np.array([0.0, 2.4, 3.0], np.float32)
        assert "atlas_fat" in rg._scene_dev, "gallery fat atlas missing"
        mrays, wall, rays = _bench_renderer(rg, spp=8, warmup_spp=8)
        _emit("gallery-atrium", mrays, wall, rays, 8,
              {"tris": rg.scene.num_triangles,
               "intersector": rg.stats()["intersector"],
               "map_sets": int(rg._scene_dev["atlas_fat_rects"].shape[0])})

    if "headline" in sel:
        r = Renderer(RenderConfig(width=512, height=512, frames_per_chunk=128))
        r.load_scene(cornell_box())
        r.render(spp=128)  # warmup / compile
        elapsed = float("inf")
        for _ in range(2):  # best of two full renders
            r.reset()
            t0 = time.perf_counter()
            r.render(spp=512, fetch=False)
            elapsed = min(elapsed, time.perf_counter() - t0)
        stats = r.stats()
        img = r.image()
        assert not np.isnan(img).any()
        mrays = stats["rays_total"] / elapsed / 1e6

        def _runh(reps):
            for _ in range(reps):
                r.render(spp=128, fetch=False, sync=False)
            r.stats()

        busy = _device_busy_ms(_runh, 2)
        _emit("cornell-512x512", mrays, elapsed, stats["rays_total"], 512,
              {"wall_clock_512spp_s": round(elapsed, 3),
               "device_busy_ms_per_128spp_chunk": round(busy, 1),
               "intersector": stats["intersector"]})


if __name__ == "__main__":
    main()
