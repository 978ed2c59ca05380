"""Adaptive-sampling tests (render/adaptive.py, opt-in extension).

The key correctness anchor: when the lane quantum forces ALL pixels into
the selected set (tiny canvases), the adaptive combine must reproduce a
plain uniform render of the same total spp — same seeds, same samples,
only the accumulation arithmetic differs (running mean vs weighted sum),
so the images agree to float-associativity tolerance. On top of that:
budget accounting, determinism, and a measured equal-budget quality win
on a DoF-noise scene (deterministic RNG makes the win reproducible).
"""

from __future__ import annotations

import numpy as np

from wgpu_path_tracing_tpu import Renderer, RenderConfig
from wgpu_path_tracing_tpu.models.procedural import cornell_box


def _mk(width=32, height=32, aperture=0.001, chunk=4):
    r = Renderer(RenderConfig(width=width, height=height,
                              frames_per_chunk=chunk))
    r.load_scene(cornell_box())
    r.camera.aperture = aperture
    return r


def test_all_selected_matches_uniform():
    # 32x32 = 1024 lanes < LANE_QUANTUM -> every round samples every
    # pixel: adaptive(8) must equal uniform(8) up to accumulation
    # arithmetic (running mean vs (mean*n0 + sum)/count).
    ra = _mk()
    img_a = ra.render_adaptive(8)
    ru = _mk()
    ru.render(8, fetch=False)
    img_u = ru._row_major(ru._accum).reshape(32, 32, 3)
    np.testing.assert_allclose(img_a, img_u, atol=2e-5)


def test_budget_accounting_and_determinism():
    ra = _mk()
    img1 = ra.render_adaptive(8)
    rays1 = int(ra._counters.sum())
    rb = _mk()
    img2 = rb.render_adaptive(8)
    np.testing.assert_array_equal(img1, img2)
    # Uniform render of the same spp casts a comparable ray count
    # (adaptive redistributes, it doesn't add).
    ru = _mk()
    ru.render(8, fetch=False)
    rays_u = int(ru._counters.sum())
    assert abs(rays1 - rays_u) / rays_u < 0.35, (rays1, rays_u)


def test_warmup_only_short_budget():
    r = _mk()
    img = r.render_adaptive(2)  # spp <= warmup floor -> plain render
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert r.frame_index == 2


def test_adaptive_beats_uniform_on_concentrated_noise():
    # The case adaptive sampling exists for: spatially CONCENTRATED
    # noise. Camera pulled back to (0, 1, 7) so the box interior covers
    # ~10% of the frame and the rest is zero-variance miss pixels (zero
    # split-buffer score -> never selected); the subset rounds pour the
    # whole extra budget into the noisy region. Deterministic RNG -> a
    # fixed, reproducible comparison; measured margin ~20% (probe,
    # round 3++). Near-UNIFORM-noise scenes (the default framing) are
    # honestly a wash for redistribution; that is not pinned here.
    def mk():
        r = _mk(64, 64, aperture=0.25, chunk=16)
        r.camera.position = np.array([0.0, 1.0, 7.0], np.float32)
        return r

    golden_r = mk()
    golden_r.render(192, fetch=False)
    golden = golden_r._row_major(golden_r._accum).reshape(64, 64, 3)

    ru = mk()
    ru.render(12, fetch=False)
    uni = ru._row_major(ru._accum).reshape(64, 64, 3)

    ra = mk()
    ada = ra.render_adaptive(12)

    rmse_u = float(np.sqrt(np.mean((uni - golden) ** 2)))
    rmse_a = float(np.sqrt(np.mean((ada - golden) ** 2)))
    # Require a real margin, not a razor tie (probe measured ~1.2x).
    assert rmse_a < 0.95 * rmse_u, (rmse_a, rmse_u)
