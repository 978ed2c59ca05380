"""Renderer orchestration — the equivalent of class Renderer
(renderer.ts:18-511) for a headless accelerator.

API parity map (reference -> here):

* ``loadModel(url)`` (renderer.ts:130-134) -> ``load_model(path)`` /
  ``load_scene(SceneArrays)``
* the rAF loop + renderFrame (renderer.ts:415-473) -> ``render(spp)``:
  progressive 1-spp frames accumulated on device in jit-scanned chunks
* ``resetOutputBuffer`` (renderer.ts:357-366) -> ``reset()`` (frame 0
  overwrites the accumulator because the running-mean weight is 1)
* ``moveCamera`` / ``rotateCamera`` (renderer.ts:152-201) -> ``move_camera``
  / ``rotate_camera`` (both reset accumulation, as in the reference)
* ``resize`` (renderer.ts:496-510) -> ``resize`` (reallocates, resets)
* ``stop``/``start`` buttons -> just call ``render`` again; accumulation
  continues from ``self.frame_index``
* tweakpane/profiler stats (renderer.ts:63-123) -> ``stats()`` dict +
  utils/profiler.py

Debug render modes (the reference's swap-in kernels pt_bvh.wgsl /
pt_debug.wgsl) are exposed via RenderConfig.mode ("bvh_depth" / "normal");
see debug/modes.py.
"""

from __future__ import annotations

import math
import time

import jax
import jax.numpy as jnp
import numpy as np

from wgpu_path_tracing_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

from wgpu_path_tracing_tpu.models.types import SceneArrays, pack_device_scene
from wgpu_path_tracing_tpu.render.camera import Camera
from wgpu_path_tracing_tpu.render.config import RenderConfig
from wgpu_path_tracing_tpu.render import pipeline
from wgpu_path_tracing_tpu.utils import image as imageio

# How many unsynced chunks' device counters may accumulate before a
# blocking drain into the host-side partial sum: bounds device-buffer
# growth for interactive loops that never hit a sync point.
DEFERRED_COUNTER_CAP = 512


class Renderer:
    def __init__(
        self,
        config: RenderConfig | None = None,
        camera: Camera | None = None,
        devices=None,
        sample_shards: int | None = None,
    ):
        """``devices``: render across multiple devices via a
        ("sample", "row") mesh (parallel/shard.py) — pass a device list, or
        True for all of ``jax.devices()``. Default: single device."""
        self.config = (config or RenderConfig()).validate()
        self.camera = camera or Camera(
            width=self.config.width,
            height=self.config.height,
            aspect=self.config.width / self.config.height,
        )
        self.mesh = None
        if devices is not None and devices is not False:
            from wgpu_path_tracing_tpu.parallel import shard as SH

            # devices=True means "use every device" and degrades to the
            # plain single-device path on a 1-device host; an EXPLICIT
            # device list always takes the shard_map path, even with one
            # device — that is how the sharding tax is measured
            # (bench.py config 10).
            all_of_them = devices is True
            if all_of_them:
                devices = jax.devices()
            if len(devices) > 1 or not all_of_them:
                self.mesh = SH.make_mesh(devices, sample_shards=sample_shards)
                rows = self.mesh.shape["row"]
                assert self.config.height % rows == 0, (
                    f"height {self.config.height} must divide the row axis {rows}"
                )
        self.scene: SceneArrays | None = None
        self._scene_dev = None
        # Async-load staging slot (see load_model_async): the background
        # thread parks the prepared scene here; it is installed from the
        # render thread at a chunk boundary (or at the next render() start).
        import threading

        self._pending_lock = threading.Lock()
        self._pending_scene: SceneArrays | None = None
        self.frame_index: int = 0
        self._accum = None
        self._counters = np.zeros(2, np.int64)
        self._last_counters = np.zeros(2, np.int64)
        # Device-side int32 counter arrays from render(sync=False) calls,
        # folded in at the next sync point (stats()/sync render/reset) —
        # lets an interactive loop pipeline chunks with NO per-call host
        # round trip (the measured small-canvas dispatch floor).
        self._deferred_counters: list = []
        # Already-pulled overflow from very long unsynced runs (the list
        # is drained every DEFERRED_COUNTER_CAP chunks so an interactive
        # loop that never reaches a sync point cannot grow device
        # buffers without bound); int64 host sum, folded into
        # _last_counters at the next sync point with the list.
        self._deferred_partial = np.zeros(2, np.int64)
        self._deferred_t0: float | None = None
        self._on_update = []
        self._last_render_seconds = 0.0
        # Pass-level profiler + frame meter (profiler.ts / fps-meter.tsx
        # equivalents; labels mirror renderer.ts:422,443).
        from wgpu_path_tracing_tpu.utils.profiler import FrameMeter, PassProfiler

        self.profiler = PassProfiler()
        self.frame_meter = FrameMeter()

    # --- scene loading -----------------------------------------------------
    def load_scene(self, scene: SceneArrays) -> None:
        self.scene = scene
        packed = pack_device_scene(scene)
        # Static per-scene texture-slot mask (host-side, before device_put):
        # scene-wide-unused slots skip their atlas fetch, exactly at the
        # Hit level (models/types.py::texture_slots_used).
        from wgpu_path_tracing_tpu.models.types import texture_slots_used

        self._slots_used = texture_slots_used(packed["tri_full"])
        if self.config.env_map is not None:
            from wgpu_path_tracing_tpu.ops.env import load_env_image

            packed["env"] = load_env_image(self.config.env_map)
            packed["env_params"] = np.array(
                [self.config.env_intensity, self.config.env_rotation],
                np.float32,
            )
        if self.mesh is not None:
            from wgpu_path_tracing_tpu.parallel import shard as SH

            self._scene_dev = SH.replicate_scene(packed, self.mesh)
        else:
            self._scene_dev = jax.device_put(packed)
        # The statically-selected intersection strategy for this scene
        # (ops/intersect.py::make_closest_hit tags it), surfaced via
        # stats().
        from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit

        self._strategy = make_closest_hit(
            packed, self.config.intersector,
            self.config.brute_force_max_tris,
            self.config.max_leaf_size).strategy
        self.reset()

    def set_environment(self, source, intensity: float = 1.0,
                        rotation: float = 0.0) -> None:
        """Install (or clear, with ``source=None``) an equirectangular
        environment map — an extension over the reference's miss -> black
        (pt.wgsl:646-649). ``source``: (H, W, 3) array or .hdr/.exr/LDR
        path; ``rotation`` in radians. Resets accumulation."""
        if self._scene_dev is None:
            raise RuntimeError("Load a scene first")
        from wgpu_path_tracing_tpu.ops.env import load_env_image

        if source is None:
            env = np.zeros((1, 1, 3), np.float32)
        else:
            env = load_env_image(source)
        params = np.array([intensity, rotation], np.float32)
        updates = {"env": env, "env_params": params}
        if self.mesh is not None:
            from wgpu_path_tracing_tpu.parallel import shard as SH

            updates = SH.replicate_scene(updates, self.mesh)
        else:
            updates = jax.device_put(updates)
        self._scene_dev = {**self._scene_dev, **updates}
        self.reset()

    def load_model(self, path: str) -> None:
        """Load a .glb/.gltf file (loader.ts:19-46 / gpu.ts:67-150 parity)."""
        from wgpu_path_tracing_tpu.models.gltf import load_model

        self.load_scene(
            load_model(
                path,
                texture_pixel_ratio=self.config.texture_pixel_ratio,
                max_leaf_size=self.config.max_leaf_size,
                num_bins=self.config.num_bins,
                enable_spot_lights=self.config.spot_lights,
            )
        )

    def load_model_async(self, path: str):
        """Off-thread scene preparation — the headless equivalent of the
        reference's Web Worker hand-off (loader.ts:23-37, scene.worker.ts):
        parsing/flattening/BVH build run on a background thread while the
        caller keeps rendering the previous scene. The prepared scene is
        STAGED, not installed — a render() in flight picks it up at its next
        chunk boundary (and resets accumulation there), so new-scene samples
        are never folded into an old-scene running mean. When no render is
        active, the next render()/``poll_pending_scene`` installs it.
        Returns a ``concurrent.futures.Future`` resolving to the scene."""
        import concurrent.futures

        from wgpu_path_tracing_tpu.models.gltf import load_model

        executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)

        def job():
            scene = load_model(
                path,
                texture_pixel_ratio=self.config.texture_pixel_ratio,
                max_leaf_size=self.config.max_leaf_size,
                num_bins=self.config.num_bins,
                enable_spot_lights=self.config.spot_lights,
            )
            with self._pending_lock:
                self._pending_scene = scene
            return scene

        future = executor.submit(job)
        executor.shutdown(wait=False)
        return future

    def poll_pending_scene(self) -> bool:
        """Install a scene staged by load_model_async, if any. Called from
        the render thread at chunk boundaries; safe to call manually."""
        with self._pending_lock:
            scene, self._pending_scene = self._pending_scene, None
        if scene is None:
            return False
        self.load_scene(scene)
        return True

    # --- interaction (controller.ts + renderer.ts:152-201) ------------------
    def add_on_update(self, callback) -> None:
        self._on_update.append(callback)

    def move_camera(self, forward: float, right: float, up: float) -> None:
        self.camera.move(forward, right, up)
        self.reset()

    def rotate_camera(self, yaw: float, pitch: float) -> None:
        self.camera.rotate(yaw, pitch)
        self.reset()

    def resize(self, width: int, height: int) -> None:
        self.config.width = width
        self.config.height = height
        self.camera.resize(width, height)
        self._accum = None
        self.reset()

    @staticmethod
    def _pull_counters(pending: list) -> np.ndarray:
        """Sum per-chunk (2,) int32 counters with ONE device->host pull.

        Stacking them on device (async, rides the dispatch queue) and
        fetching the (k, 2) result once costs one host sync instead of k.
        Int32 per chunk, summed in int64 on the host — a device-side
        int32 running sum could overflow on deep spp."""
        if not pending:
            return np.zeros(2, np.int64)
        if len(pending) == 1:
            return np.asarray(pending[0], np.int64)
        # Pad to the next power of two with zeros so the stack program
        # comes from a small, quickly-warmed shape set.
        k = 1 << (len(pending) - 1).bit_length()
        pad = [jnp.zeros_like(pending[0])] * (k - len(pending))
        stacked = np.asarray(jnp.stack(pending + pad), np.int64)
        return stacked.sum(axis=0)

    def _sync_deferred(self) -> None:
        """Fold counters from render(sync=False) calls into the totals.
        The whole unsynced run counts as the 'last render' for stats():
        its wall clock spans first dispatch -> this sync (the counter
        pull blocks until every chunk completes), so mrays_per_sec stays
        honest — never real rays over dispatch-only seconds. Idle time
        between completion and the stats() call counts against it, the
        conservative direction."""
        if not self._deferred_counters and not self._deferred_partial.any():
            return
        add = self._deferred_partial + self._pull_counters(
            self._deferred_counters)
        self._deferred_counters = []
        self._deferred_partial = np.zeros(2, np.int64)
        self._last_counters = add
        self._counters = self._counters + add
        if self._deferred_t0 is not None:
            self._last_render_seconds = time.perf_counter() - self._deferred_t0
            self._deferred_t0 = None

    def reset(self) -> None:
        """resetOutputBuffer (renderer.ts:357-366): restart accumulation."""
        self.frame_index = 0
        self._counters = np.zeros(2, np.int64)
        self._deferred_counters = []
        self._deferred_partial = np.zeros(2, np.int64)
        self._deferred_t0 = None

    # --- rendering ----------------------------------------------------------
    def _ensure_accum(self):
        n = self.config.width * self.config.height
        if self._accum is None or self._accum.shape[0] != n:
            accum = jnp.zeros((n, 3), jnp.float32)
            if self.mesh is not None:
                from wgpu_path_tracing_tpu.parallel import shard as SH

                accum = SH.shard_accum(accum, self.mesh)
            self._accum = accum

    def _row_major(self, accum) -> np.ndarray:
        """Device buffers are tile-ordered (utils/tiling.py); convert back."""
        from wgpu_path_tracing_tpu.utils.tiling import (
            inverse_permutation,
            tile_permutation,
        )

        if self.mesh is not None:
            from wgpu_path_tracing_tpu.parallel import shard as SH

            return SH.untile_image(
                SH.gather_image(accum),
                self.config.width,
                self.config.height,
                self.mesh.shape["row"],
            )
        perm = tile_permutation(self.config.width, self.config.height)
        return np.asarray(accum)[inverse_permutation(perm)]

    def _tile_order(self, accum_row_major: np.ndarray):
        from wgpu_path_tracing_tpu.utils.tiling import tile_permutation

        if self.mesh is not None:
            from wgpu_path_tracing_tpu.utils.tiling import inverse_permutation
            from wgpu_path_tracing_tpu.parallel import shard as SH

            rows = self.mesh.shape["row"]
            local = self.config.height // rows * self.config.width
            perm_l = tile_permutation(self.config.width,
                                      self.config.height // rows)
            tiled = accum_row_major.reshape(rows, local, 3)[:, perm_l].reshape(
                -1, 3
            )
            return SH.shard_accum(jnp.asarray(tiled), self.mesh)
        perm = tile_permutation(self.config.width, self.config.height)
        return jnp.asarray(accum_row_major[perm])

    def render(self, spp: int, on_chunk=None, fetch: bool = True,
               sync: bool = True):
        """Accumulate ``spp`` more samples per pixel; returns the HDR buffer
        as (H, W, 3) NumPy (row 0 = bottom of view, as in the reference's
        output buffer).

        ``fetch=False`` skips the final device->host image transfer and
        returns None — the small-canvas fast path (the reference never
        reads the GPU buffer back either; its blit stays on-device,
        renderer.ts:434-448). Timing stays honest: the ray counters are
        pulled once at the end, which forces the whole chunk chain to
        complete before the wall clock stops.

        ``sync=False`` (implies no fetch) additionally skips that counter
        pull: the call returns as soon as the chunks are DISPATCHED, and
        the counters fold in at the next sync point (``stats()``, a sync
        render, or ``reset``). This is the interactive-loop mode — the
        reference's rAF loop never blocks on the GPU either
        (renderer.ts:456-473); small canvases are otherwise bound by the
        per-call host round trip, not device time."""
        self.poll_pending_scene()
        if self._scene_dev is None:
            raise RuntimeError("No scene loaded — call load_model/load_scene first")
        cfg = self.config
        if cfg.mode != "pt":
            return self.render_debug()
        self._ensure_accum()
        cam = pipeline.camera_device(self.camera.as_pytree(), cfg.width, cfg.height)
        use_dof = float(self.camera.aperture) > 0.0

        t0 = time.perf_counter()
        remaining = spp
        counters_dev: list = []
        while remaining > 0:
            self.poll_pending_scene()
            for task in self._on_update:
                task(0.0)
            chunk = min(cfg.frames_per_chunk, remaining)
            chunk_t0 = time.perf_counter()
            # gcd keeps any tail chunk divisible; extra compile shapes only
            # arise for spp not a multiple of frames_per_trace.
            fpt = math.gcd(max(1, int(getattr(cfg, "frames_per_trace", 1))),
                           chunk)
            common = dict(
                n_frames=chunk,
                width=cfg.width,
                height=cfg.height,
                use_dof=use_dof,
                rng_mode=cfg.rng,
                max_bounces=cfg.max_bounces,
                do_mis=cfg.do_mis,
                num_lights=self.scene.num_lights,
                firefly_clamp=cfg.firefly_clamp,
                intersector=cfg.intersector,
                brute_max_tris=cfg.brute_force_max_tris,
                leaf_size=cfg.max_leaf_size,
                slots_used=getattr(self, "_slots_used",
                                   (True, True, True, True)),
            )
            if self.mesh is not None:
                from wgpu_path_tracing_tpu.parallel import shard as SH

                # The jitted shape needs n_frames % sample_shards == 0.
                # Steady-state chunks round DOWN to a full-weight multiple
                # (no wasted frames); only a final sub-multiple remainder is
                # padded up with zero-weighted frames so render(spp)
                # accumulates exactly spp frames.
                ns = self.mesh.shape["sample"]
                if chunk >= ns:
                    chunk -= chunk % ns
                common["n_frames"] = chunk + (-chunk) % ns
                common["n_active"] = chunk
                # Per-shard batching (gcd-clamped to the local frame
                # count inside render_chunk_sharded; padded tail chunks
                # drop to F=1 there).
                common["frames_per_trace"] = fpt
                self._accum, counters = SH.render_chunk_sharded(
                    self._scene_dev,
                    cam,
                    self._accum,
                    jnp.int32(self.frame_index),
                    mesh=self.mesh,
                    **common,
                )
            else:
                self._accum, counters = pipeline.render_chunk(
                    self._scene_dev,
                    cam,
                    self._accum,
                    jnp.int32(self.frame_index),
                    frames_per_trace=fpt,
                    **common,
                )
            # Counters stay ON DEVICE until the render completes; the sync
            # point stacks them device-side and pulls ONCE
            # (_pull_counters).
            counters_dev.append(counters)
            if on_chunk is not None:
                # Per-chunk consumers (preview PNG, progress) need real
                # data — sync here so their view is complete.
                np.asarray(counters)
            self.profiler.add("path-trace-pass", (time.perf_counter() - chunk_t0) / chunk)
            for _ in range(chunk):
                self.frame_meter.tick()
            self.frame_index += chunk
            remaining -= chunk
            if on_chunk is not None:
                on_chunk(self.frame_index)
        if not sync:
            # Documented implication: sync=False returns at dispatch, so
            # there is nothing to fetch — forcing fetch=False here keeps
            # the call non-blocking instead of silently syncing on the
            # image pull.
            fetch = False
            if self._deferred_t0 is None:
                self._deferred_t0 = t0
            self._deferred_counters.extend(counters_dev)
            if len(self._deferred_counters) >= DEFERRED_COUNTER_CAP:
                self._deferred_partial = (
                    self._deferred_partial
                    + self._pull_counters(self._deferred_counters))
                self._deferred_counters = []
            # Dispatch-only time; provisional. The next sync point
            # (stats(), a sync render) replaces it with the full
            # dispatch-to-completion wall of the unsynced run, so
            # stats() never divides real ray counts by enqueue time.
            self._last_render_seconds = time.perf_counter() - t0
        else:
            # A sync render folds any earlier unsynced chunks in: the
            # 'last render' then spans from the first unsynced dispatch.
            if fetch and self.mesh is None:
                # Overlap the two host transfers this call pays (the
                # counter pull below + the image pull in _row_major):
                # start the accum D2H copy NOW so it runs concurrently
                # with the counter fetch — np.asarray later finds the
                # cached host copy (the reference does motion -> fresh
                # frame inside one rAF tick, renderer.ts:456-473).
                try:
                    self._accum.copy_to_host_async()
                except AttributeError:
                    pass
            had_deferred = (bool(self._deferred_counters)
                            or self._deferred_partial.any())
            start = (self._deferred_t0
                     if had_deferred and self._deferred_t0 is not None
                     else t0)
            pending = self._deferred_counters + counters_dev
            self._deferred_counters = []
            self._deferred_t0 = None
            render_counters = (self._deferred_partial
                               + self._pull_counters(pending))
            self._deferred_partial = np.zeros(2, np.int64)
            self._last_counters = render_counters
            self._counters = self._counters + render_counters
            self._last_render_seconds = time.perf_counter() - start

        if not fetch:
            return None
        return self._row_major(self._accum).reshape(cfg.height, cfg.width, 3)

    def render_debug(self) -> np.ndarray:
        from wgpu_path_tracing_tpu.debug import modes

        cfg = self.config
        cam = pipeline.camera_device(self.camera.as_pytree(), cfg.width, cfg.height)
        if cfg.mode == "bvh_depth":
            buf = modes.render_bvh_depth(self._scene_dev, cam, cfg.width, cfg.height)
        else:
            buf = modes.render_normal(
                self._scene_dev, cam, cfg.width, cfg.height,
                intersector=cfg.intersector,
                brute_max_tris=cfg.brute_force_max_tris,
                leaf_size=cfg.max_leaf_size,
                slots_used=getattr(self, "_slots_used",
                                   (True, True, True, True)),
            )
        return np.asarray(buf).reshape(cfg.height, cfg.width, 3)

    # --- checkpoint / resume --------------------------------------------------
    # The reference's accumulation is restart-only (renderer.ts:357-366);
    # SURVEY.md §5 calls out an spp-stamped checkpoint as the natural upgrade.
    @staticmethod
    def _ckpt_path(path: str) -> str:
        # np.savez appends '.npz' when missing; normalize so save and load
        # agree on the actual filename.
        return path if path.endswith(".npz") else path + ".npz"

    def save_checkpoint(self, path: str) -> None:
        if self._accum is None:
            raise RuntimeError("Nothing to checkpoint")
        np.savez(
            self._ckpt_path(path),
            accum=self._row_major(self._accum),
            frame_index=self.frame_index,
            width=self.config.width,
            height=self.config.height,
            camera_position=self.camera.position,
            camera_forward=self.camera.forward,
            camera_right=self.camera.right,
            camera_up=self.camera.up,
            camera_fov=self.camera.fov,
            camera_aperture=self.camera.aperture,
            camera_focus_distance=self.camera.focus_distance,
        )

    def load_checkpoint(self, path: str) -> None:
        data = np.load(self._ckpt_path(path))
        w, h = int(data["width"]), int(data["height"])
        if (w, h) != (self.config.width, self.config.height):
            self.resize(w, h)
        self.camera.position = data["camera_position"].astype(np.float32)
        self.camera.forward = data["camera_forward"].astype(np.float32)
        self.camera.right = data["camera_right"].astype(np.float32)
        self.camera.up = data["camera_up"].astype(np.float32)
        self.camera.fov = float(data["camera_fov"])
        self.camera.aperture = float(data["camera_aperture"])
        self.camera.focus_distance = float(data["camera_focus_distance"])
        self._accum = self._tile_order(data["accum"])
        self.frame_index = int(data["frame_index"])

    # --- denoising (opt-in extension; ops/denoise.py) -------------------------
    def aovs(self, lens_samples: int | None = None) -> dict:
        """Primary-hit guide buffers (albedo/normal/depth/found) for the
        denoiser, using the production intersector selection. Row-major
        (N,) / (N, 3) arrays; cheap next to any real render (camera-
        coherent traversals only, no bounces).

        ``lens_samples``: None (default) = pinhole center rays. Lens
        averaging (K thin-lens guide samples) is an explicit opt-in (pass
        K > 0): guide noise in defocused regions weakens the
        edge-stopping weights."""
        if self._scene_dev is None:
            raise RuntimeError("No scene loaded")
        from wgpu_path_tracing_tpu.ops import denoise as DN

        cfg = self.config
        if lens_samples is None:
            lens_samples = 0
        cam = pipeline.camera_device(self.camera.as_pytree(), cfg.width,
                                     cfg.height)
        scene = self._scene_dev
        if self.mesh is not None:
            # The AOV pass is a single cheap camera-coherent call; run it
            # on one device from the replicated scene copy.
            scene = jax.tree_util.tree_map(
                lambda a: np.asarray(a)
                if hasattr(a, "addressable_shards") else a, scene)
        return DN.primary_aovs(
            scene, cam, cfg.width, cfg.height,
            intersector=cfg.intersector,
            brute_max_tris=cfg.brute_force_max_tris,
            leaf_size=cfg.max_leaf_size,
            slots_used=getattr(self, "_slots_used", (True, True, True, True)),
            lens_samples=int(lens_samples),
            rng_mode=cfg.rng,
        )

    def denoise(self, hdr: np.ndarray | None = None, **params) -> np.ndarray:
        """Edge-avoiding à-trous denoise of the current LINEAR accumulation
        (ops/denoise.py; guided by ``aovs()``). Returns a new (H, W, 3)
        HDR array — accumulation itself is untouched (parity), so
        progressive rendering continues unaffected afterwards. ``params``
        forward to ops/denoise.denoise_image (levels, sigma_*). Pass
        ``hdr`` to filter an external buffer instead (e.g. the
        render_adaptive result) using this renderer's guides."""
        if hdr is None:
            if self._accum is None:
                raise RuntimeError("Nothing rendered yet")
            hdr = self._row_major(self._accum).reshape(
                self.config.height, self.config.width, 3)
        from wgpu_path_tracing_tpu.ops import denoise as DN

        params.setdefault("spp", self.frame_index)
        return DN.denoise_image(hdr, self.aovs(), **params)

    def render_adaptive(self, spp: int, **kw) -> np.ndarray:
        """Adaptive sampling (opt-in extension, render/adaptive.py):
        ~``spp`` frames of ray budget, concentrated on the noisiest
        pixels after a uniform warmup. Returns the combined (H, W, 3)
        HDR image; the renderer's own accumulation keeps only the
        uniform warmup part (see the module docstring for semantics)."""
        from wgpu_path_tracing_tpu.render import adaptive

        return adaptive.render_adaptive(self, spp, **kw)

    # --- output --------------------------------------------------------------
    def image(self, denoise: bool = False) -> np.ndarray:
        """Tonemapped display image (H, W, 3) in [0,1], top row first.
        ``denoise=True`` runs the opt-in à-trous filter on a copy of the
        HDR buffer first (default path bit-identical)."""
        if self._accum is None:
            raise RuntimeError("Nothing rendered yet")
        with self.profiler.section("blit-pass"):
            if denoise:
                hdr = self.denoise().reshape(-1, 3)
                return imageio.buffer_to_srgb(
                    hdr, self.config.width, self.config.height,
                    self.config.exposure,
                )
            return imageio.buffer_to_srgb(
                self._row_major(self._accum),
                self.config.width,
                self.config.height,
                self.config.exposure,
            )

    def save_png(self, path: str, denoise: bool = False) -> None:
        imageio.write_png(path, self.image(denoise=denoise))

    def save_hdr(self, path: str) -> None:
        """Write the LINEAR accumulation as a Radiance RGBE .hdr (no
        tonemap) — the headless analog of the reference's HDR canvas
        (rgba16float + toneMapping, renderer.ts:535-541)."""
        if self._accum is None:
            raise RuntimeError("Nothing rendered yet")
        hdr = self._row_major(self._accum).reshape(
            self.config.height, self.config.width, 3
        )
        imageio.write_hdr(path, np.nan_to_num(hdr[::-1], nan=0.0))

    def save_exr(self, path: str) -> None:
        """Write the LINEAR accumulation as an OpenEXR (f32, lossless) —
        same buffer as save_hdr, exact instead of RGBE-quantized."""
        if self._accum is None:
            raise RuntimeError("Nothing rendered yet")
        hdr = self._row_major(self._accum).reshape(
            self.config.height, self.config.width, 3
        )
        imageio.write_exr(path, np.nan_to_num(hdr[::-1], nan=0.0))

    # --- metrics (profiler.ts / fps-meter.tsx equivalents) -------------------
    def stats(self) -> dict:
        self._sync_deferred()
        closest, shadow = (int(c) for c in self._counters)
        last_total = int(self._last_counters.sum())
        secs = max(self._last_render_seconds, 1e-9)
        return {
            "frame_index": self.frame_index,
            "intersector": getattr(self, "_strategy", None),
            "rays_closest": closest,
            "rays_shadow": shadow,
            "rays_total": closest + shadow,
            "last_render_seconds": self._last_render_seconds,
            "mrays_per_sec": last_total / secs / 1e6 if last_total else 0.0,
            "passes": self.profiler.stats(),
            "frames": self.frame_meter.stats(),
        }
