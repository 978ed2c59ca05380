"""Adaptive sampling (opt-in extension) — spend rays where the noise is.

The reference distributes samples uniformly (1 spp per pixel per frame,
renderer.ts:415-454) and so does this framework's default path. Uniform
sampling spends rays evenly where noise is not even: converged pixels
(directly lit walls) get the same budget as high-variance ones (DoF
bokeh, glass caustics, penumbrae).

Scheme:

1. **Uniform warmup** through ``render_chunk_m2`` — the same frame
   schedule, seeds, and accumulation arithmetic as the default
   render_chunk, plus a parallel running mean of the clamped per-frame
   color SQUARED. E[x²] − E[x]² over the n0 warmup frames is a proper
   per-pixel per-channel σ² estimate — the round-3 split-buffer |B − A|
   score this replaces was a single χ²₁-distributed draw of the same
   quantity (relative std ≈ √2 ≈ 141% vs √(2/(n0−1)) here), and its
   noise — frozen into the selection for the whole run — was the
   measured low-spp failure mode.
2. **Per-pixel error score** in DISPLAY space: the linear σ is pushed
   through the display transform as |T(μ+σ) − T(μ−σ)|/2 summed over
   channels — display space is what quality metrics (and eyes) measure,
   and its gamma expands exactly the dark regions where linear-space
   scores under-weight noise.
3. **Subset rounds**: the noisiest K = select_frac·N pixels (top-K lanes,
   static shape → one compile) each get one more sample per round via
   ``render_chunk_subset`` — the same trace machinery over K lanes with
   scatter-add into (sum, sum², count) side buffers. A round costs
   ~select_frac of a uniform frame.
4. **Reselection every round** (host-side: counts are tracked locally,
   so a reselect costs an argpartition over N floats plus three small
   device_puts — no extra pulls) by MARGINAL MSE gain: one more sample
   at pixel i reduces its MSE by σᵢ²(1/nᵢ − 1/(nᵢ+1)) ≈ (σᵢ/nᵢ)², so
   greedy-optimal selection ranks by score/nᵢ. (Ranking by
   score/sqrt(nᵢ) instead — equalizing per-pixel ERROR — was measured
   0.179 vs 0.158 uniform on glass-dof@16spp: it over-concentrates; the
   marginal-gain rule is what the equal-budget win below uses.) Every
   ``refresh_every`` rounds the σ estimate itself is REFRESHED from the
   combined warmup+extra moments (two (N, 3) pulls), so heavy-tailed
   pixels whose extra samples reveal a smaller true σ release their
   budget — the glass-firefly fix. The score is smoothed 3×3
   (zero-score pixels — converged or miss — stay zero and are never
   sampled).
5. Final image: (warmup_mean·n0 + extra_sum) / (n0 + extra_count).

Parity: the default render path is untouched — warmup frames draw the
same seeds and fold with the same running-mean expressions as a plain
render(n0) (radiance equal; the accumulation buffer may differ by XLA
fusion ulps since the m2 line traces alongside), and the extension only
ADDS samples in separate side buffers. Each pixel's estimate is a plain
average of its unique (pixel, frame)-seeded samples (the standard mild
adaptive bias — sample counts correlate with observed noise — applies,
as in any adaptive sampler). Single-device only (the warmup may be
sharded, but subset rounds run on the default device).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from wgpu_path_tracing_tpu.ops import camera_rays as CAM
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu.render.pipeline import make_trace_fn

# Subset lane counts are rounded up to a multiple of this so the kernels
# see friendly shapes and reselection never changes the compile key.
LANE_QUANTUM = 2048

# Measured-by-probe knobs (module-level so A/B probes can flip them in
# one process; production values are the measured winners):
#   _PRED_RULE: "n" ranks by marginal MSE gain (score/n_i), "sqrt"
#   equalizes per-pixel error (score/sqrt(n_i)).
#   _BLUR: 3x3 image-space smoothing of the warmup score.
_PRED_RULE = "n"
_BLUR = True


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_frames", "width", "height", "use_dof", "rng_mode", "max_bounces",
        "do_mis", "num_lights", "firefly_clamp", "intersector",
        "brute_max_tris", "leaf_size", "slots_used",
    ),
    donate_argnames=("accum", "m2"),
)
def render_chunk_m2(
    scene,
    cam,
    accum,
    m2,
    frame_start,
    *,
    n_frames: int,
    width: int,
    height: int,
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
):
    """Warmup variant of render/pipeline.py::render_chunk that ALSO folds
    the clamped per-frame color SQUARED into a second running mean ``m2``
    (same (N, 3) shape/order as ``accum``): after n frames,
    ``m2 − accum²`` is the per-pixel per-channel sample variance — the
    σ estimator the adaptive selection ranks on. Frame seeds, draw
    schedule, and the accumulation expressions are identical to
    render_chunk at frames_per_trace=1 (radiance bit-equal; the buffer
    may differ by XLA fusion ulps since the extra line traces alongside).
    Returns (accum, m2, counters)."""
    from wgpu_path_tracing_tpu.utils.tiling import tile_permutation

    x, y = CAM.pixel_grid(width, height)
    perm = jnp.asarray(tile_permutation(width, height))
    x = x[perm]
    y = y[perm]
    closest_hit = make_closest_hit(scene, intersector, brute_max_tris,
                                   leaf_size)
    trace_fn = make_trace_fn(
        scene, closest_hit,
        max_bounces=max_bounces, do_mis=do_mis, num_lights=num_lights,
        slots_used=slots_used, rng_mode=rng_mode,
    )

    def step(carry, k):
        accum, m2, counters = carry
        frame = frame_start + k
        ro, rd, state = CAM.generate_rays(
            cam, x, y, frame, use_dof=use_dof, rng_mode=rng_mode)
        lds0 = (CAM.bounce0_lds(x, y, frame)
                if trace_fn.lds_active else None)
        radiance, state, stats = trace_fn(ro, rd, state, lds0)
        counters = counters + jnp.stack([stats["closest"], stats["shadow"]])
        color = jnp.minimum(radiance, jnp.float32(firefly_clamp))
        t = 1.0 / (frame.astype(jnp.float32) + 1.0)
        accum = accum * (1.0 - t) + color * t
        m2 = m2 * (1.0 - t) + color * color * t
        return (accum, m2, counters), None

    counters0 = jnp.zeros((2,), jnp.int32)
    (accum, m2, counters), _ = jax.lax.scan(
        step, (accum, m2, counters0),
        jnp.arange(n_frames, dtype=jnp.int32))
    return accum, m2, counters


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_frames", "use_dof", "rng_mode", "max_bounces", "do_mis",
        "num_lights", "firefly_clamp", "intersector", "brute_max_tris",
        "leaf_size", "slots_used",
    ),
    donate_argnames=("extra_sum", "extra_sum2", "extra_count"),
)
def render_chunk_subset(
    scene,
    cam,
    extra_sum,
    extra_sum2,
    extra_count,
    x,
    y,
    lane_idx,
    frame_start,
    *,
    n_frames: int,
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
):
    """``n_frames`` one-sample rounds for the K pixels in (x, y), each
    scatter-added into the full-frame (N, 3)/(N, 3)/(N,) side buffers at
    ``lane_idx`` (sum, sum-of-squares, count — the squares feed the
    periodic σ refresh). Seeds come from the global frame counter exactly
    like the uniform pipeline, so a pixel's adaptive samples are the ones
    a longer uniform render would eventually have drawn."""
    closest_hit = make_closest_hit(scene, intersector, brute_max_tris,
                                   leaf_size)
    trace_fn = make_trace_fn(
        scene, closest_hit,
        max_bounces=max_bounces, do_mis=do_mis, num_lights=num_lights,
        slots_used=slots_used, rng_mode=rng_mode,
    )

    def step(carry, k):
        extra_sum, extra_sum2, extra_count, counters = carry
        frame = frame_start + k
        ro, rd, state = CAM.generate_rays(
            cam, x, y, frame, use_dof=use_dof, rng_mode=rng_mode)
        lds0 = (CAM.bounce0_lds(x, y, frame)
                if trace_fn.lds_active else None)
        radiance, state, stats = trace_fn(ro, rd, state, lds0)
        color = jnp.minimum(radiance, jnp.float32(firefly_clamp))
        extra_sum = extra_sum.at[lane_idx].add(color)
        extra_sum2 = extra_sum2.at[lane_idx].add(color * color)
        extra_count = extra_count.at[lane_idx].add(1)
        counters = counters + jnp.stack([stats["closest"], stats["shadow"]])
        return (extra_sum, extra_sum2, extra_count, counters), None

    counters0 = jnp.zeros((2,), jnp.int32)
    (extra_sum, extra_sum2, extra_count, counters), _ = jax.lax.scan(
        step, (extra_sum, extra_sum2, extra_count, counters0),
        jnp.arange(n_frames, dtype=jnp.int32))
    return extra_sum, extra_sum2, extra_count, counters


def _display_sigma_score(mean_lin: np.ndarray,
                         sigma_lin: np.ndarray) -> np.ndarray:
    """Per-lane display-space σ: |T(μ+σ) − T(μ−σ)|/2 summed over channels.

    The AGX display chain is per-pixel, so it runs directly on the flat
    LANE-ordered buffers (no display reshape/flip needed) — the selection
    wants lane order anyway. Pushing the ±σ interval through the full
    transform weights linear noise by the local tonemap slope (gamma
    expands the dark regions where linear scores under-weight noise)
    without needing an analytic derivative of the AGX chain."""
    from wgpu_path_tracing_tpu.ops.tonemap import display_transform

    # Dark floor: the parity AGX chain NaNs below ~1e-4 linear (the
    # sigmoid goes slightly negative and agx_eotf's pow(neg, 2.2) is NaN
    # — blit.wgsl semantics; the PNG writer masks it). Clamping both
    # interval ends at 1e-3 keeps the transform NaN-free and crushes
    # score differences below the display's black floor to exactly zero
    # (converged dark/miss pixels are never worth a ray).
    floor = np.float32(1e-3)
    hi = np.asarray(display_transform(
        jnp.asarray(np.maximum(mean_lin + sigma_lin, floor))))
    lo = np.asarray(display_transform(
        jnp.asarray(np.maximum(mean_lin - sigma_lin, floor))))
    return np.nan_to_num(np.abs(hi - lo).sum(axis=-1) * 0.5)


def _score_from_moments(mean_lin, ex2_lin, n_samples) -> np.ndarray:
    """Display-space σ score from (mean, E[x²]) buffers of ``n_samples``
    draws, with the n/(n−1) small-sample variance correction."""
    var = np.maximum(ex2_lin - mean_lin * mean_lin, 0.0)
    n = np.asarray(n_samples, np.float64).reshape(-1, 1)
    var = var * (n / np.maximum(n - 1.0, 1.0))
    return _display_sigma_score(mean_lin, np.sqrt(var).astype(np.float32))


def render_adaptive(
    renderer,
    spp: int,
    *,
    warmup_frac: float = 0.5,
    select_frac: float = 0.25,
    reselect_every: int = 1,
    refresh_every: int = 4,
) -> np.ndarray:
    """Render ~``spp`` frames of ray budget adaptively; returns the
    combined HDR image (H, W, 3), row 0 = bottom (like render()).

    The renderer's own accumulation afterwards holds the uniform warmup
    only (parity-clean); treat this call as terminal for the current
    accumulation — continuing with plain render() would reuse frame
    seeds the adaptive rounds already consumed for the selected pixels
    (documented limitation, same class as resuming a checkpoint with a
    different frame_index).
    """
    if renderer.mesh is not None:
        raise NotImplementedError(
            "adaptive sampling runs single-device (warmup may be sharded "
            "in a future round)")
    cfg = renderer.config
    w, h = cfg.width, cfg.height
    n = w * h
    n0 = max(2, int(round(spp * warmup_frac)))
    if spp <= n0 or n0 < 2:
        renderer.render(spp, fetch=False)
        return renderer._row_major(renderer._accum).reshape(h, w, 3)

    scene_dev = renderer._scene_dev
    from wgpu_path_tracing_tpu.render import pipeline

    cam = pipeline.camera_device(renderer.camera.as_pytree(), w, h)
    use_dof = float(renderer.camera.aperture) > 0.0
    common = dict(
        use_dof=use_dof,
        rng_mode=cfg.rng,
        max_bounces=cfg.max_bounces,
        do_mis=cfg.do_mis,
        num_lights=renderer.scene.num_lights,
        firefly_clamp=cfg.firefly_clamp,
        intersector=cfg.intersector,
        brute_max_tris=cfg.brute_force_max_tris,
        leaf_size=cfg.max_leaf_size,
        slots_used=getattr(renderer, "_slots_used", (True, True, True, True)),
    )

    # 1. Warmup through render_chunk_m2: the default chunk schedule and
    # seeds, plus the running mean of color² that makes σ estimable.
    renderer._ensure_accum()
    accum = renderer._accum
    m2 = jnp.zeros_like(accum)
    remaining = n0
    counters_dev = []
    while remaining > 0:
        chunk = min(cfg.frames_per_chunk, remaining)
        accum, m2, c = render_chunk_m2(
            scene_dev, cam, accum, m2, jnp.int32(renderer.frame_index),
            n_frames=chunk, width=w, height=h, **common)
        counters_dev.append(c)
        renderer.frame_index += chunk
        remaining -= chunk
    renderer._accum = accum
    warm_counters = renderer._pull_counters(counters_dev)
    renderer._counters = renderer._counters + warm_counters
    renderer._last_counters = warm_counters
    base = np.asarray(accum, np.float32)
    m2_h = np.asarray(m2, np.float32)

    # 2. Display-space σ score per lane (see _score_from_moments),
    # smoothed 3x3 in IMAGE space (noise is spatially correlated and an
    # n0-sample σ estimate still carries ~√(2/(n0−1)) relative noise).
    # Exactly-zero scores (converged pixels, misses) stay zero — never
    # worth a ray.
    score = _score_from_moments(base, m2_h, np.full(n, n0))
    from wgpu_path_tracing_tpu.utils.tiling import (
        inverse_permutation,
        tile_permutation,
    )

    perm = tile_permutation(w, h)
    inv = inverse_permutation(perm)

    def _blurred(score):
        if not _BLUR:
            return score
        img_score = score[inv].reshape(h, w)
        pad = np.pad(img_score, 1, mode="edge")
        sm = sum(pad[dy:dy + h, dx:dx + w]
                 for dy in range(3) for dx in range(3)) / 9.0
        return np.where(img_score.reshape(-1) > 0.0,
                        sm.reshape(-1), 0.0)[perm]

    score = _blurred(score)

    # 3. Static-K subset rounds.
    k = int(round(n * select_frac))
    k = max(LANE_QUANTUM, ((k + LANE_QUANTUM - 1) // LANE_QUANTUM)
            * LANE_QUANTUM)
    k = min(k, n)
    rounds_total = int(round((spp - n0) * n / k))
    if rounds_total == 0:
        return renderer._row_major(renderer._accum).reshape(h, w, 3)

    x_rm, y_rm = np.divmod(np.arange(n, dtype=np.int64), w)[::-1]
    # pixel_grid flattens row-major (index = y*w + x); lane i is pixel
    # perm[i] of that order — the same permutation pipeline applies.
    x_t = x_rm[perm].astype(np.int32)
    y_t = y_rm[perm].astype(np.int32)

    extra_sum = jnp.zeros((n, 3), jnp.float32)
    extra_sum2 = jnp.zeros((n, 3), jnp.float32)
    extra_count = jnp.zeros((n,), jnp.int32)
    extra_count_host = np.zeros(n, np.int64)

    frame = n0
    done = 0
    rounds_done = 0
    while done < rounds_total:
        if (refresh_every and rounds_done
                and rounds_done % refresh_every == 0):
            # 4b. σ REFRESH from the combined warmup+extra moments (two
            # (N, 3) pulls): pixels whose extra samples revealed a
            # smaller true σ — the heavy-tailed warmup-firefly class —
            # release their budget back to the pool.
            n_i = (n0 + extra_count_host).astype(np.float64)
            s1 = np.asarray(extra_sum, np.float32)
            s2 = np.asarray(extra_sum2, np.float32)
            mean_c = ((base * n0 + s1) / n_i[:, None]).astype(np.float32)
            ex2_c = ((m2_h * n0 + s2) / n_i[:, None]).astype(np.float32)
            score = _blurred(_score_from_moments(mean_c, ex2_c, n_i))
        # Marginal MSE gain of one more sample ~ (sigma_i/n_i)^2:
        # greedy-optimal rank is score/n_i (see module docstring).
        n_i = n0 + extra_count_host
        pred = score / (n_i if _PRED_RULE == "n" else np.sqrt(n_i))
        sel = np.argpartition(pred, n - k)[n - k:]
        sel_dev = jnp.asarray(sel.astype(np.int32))
        x_dev = jnp.asarray(x_t[sel])
        y_dev = jnp.asarray(y_t[sel])
        r_n = min(reselect_every, rounds_total - done)
        extra_sum, extra_sum2, extra_count, counters = render_chunk_subset(
            scene_dev, cam, extra_sum, extra_sum2, extra_count,
            x_dev, y_dev, sel_dev, jnp.int32(frame),
            n_frames=r_n, **common)
        extra_count_host[sel] += r_n
        renderer._counters = renderer._counters + np.asarray(
            counters, np.int64)
        frame += r_n
        done += r_n
        rounds_done += 1

    # 5. Combine (device-side, one pull).
    base_dev = renderer._accum
    denom = jnp.float32(n0) + extra_count.astype(jnp.float32)
    combined = (base_dev * jnp.float32(n0) + extra_sum) / denom[:, None]
    return renderer._row_major(np.asarray(combined)).reshape(h, w, 3)
