"""Golden-image regression: the CPU render of the built-in Cornell box must
stay within Monte-Carlo-free tolerance of a committed fixture.

This is the framework's stand-in for the reference's committed sample renders
(docs/img/cornell_*.png, README.md:9-11; the cornell.glb that produced them
is stripped from the mirror, SURVEY.md §4) — same idea: any change to
sampling, shading, accumulation, or tonemapping shows up as image drift.
"""

import os

import numpy as np

from wgpu_path_tracing_tpu import Renderer, RenderConfig, cornell_box
from wgpu_path_tracing_tpu.utils.image import read_png, rmse

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def test_cornell_golden_hdr_buffer():
    r = Renderer(RenderConfig(width=48, height=48, frames_per_chunk=8))
    r.load_scene(cornell_box())
    buf = r.render(spp=8)
    golden = np.load(os.path.join(GOLDEN_DIR, "cornell_48x48_8spp.npz"))["accum"]
    # Same seeds, same math: only compiler reassociation drift is allowed.
    np.testing.assert_allclose(buf, golden, rtol=5e-4, atol=5e-4)


def test_cornell_golden_display_png():
    r = Renderer(RenderConfig(width=48, height=48, frames_per_chunk=8))
    r.load_scene(cornell_box())
    r.render(spp=8)
    img = r.image()
    golden = read_png(os.path.join(GOLDEN_DIR, "cornell_48x48_8spp.png"))
    assert rmse(img, golden) < 2.0 / 255.0


def test_reference_golden_rmse_replica():
    """Best-effort RMSE against the REFERENCE's own golden
    (docs/img/cornell_512spp.png): the source cornell.glb is stripped from
    the mirror, so models/replica.py reconstructs it (room = cornell2.glb
    parity; objects estimated visually; the textured figurine is a
    documented stand-in). This low-res/low-spp CPU check only guards
    against gross
    regressions (mirrored walls, lost objects, broken display chain) — the
    threshold is dominated by Monte-Carlo noise plus the reconstruction
    residual, NOT renderer error (parity is covered by the oracle suite).
    """
    import pytest

    golden_png = "/root/reference/docs/img/cornell_512spp.png"
    if not os.path.exists(golden_png):
        pytest.skip("reference mirror not available")
    import sys

    sys.path.insert(
        0, os.path.join(os.path.dirname(__file__), "..", "tools")
    )
    import golden_rmse

    from wgpu_path_tracing_tpu.models.replica import cornell_replica

    r = Renderer(RenderConfig(width=48, height=48, frames_per_chunk=4))
    r.load_scene(cornell_replica())
    r.camera.position[2] = 2.0
    r.render(spp=8)
    out = os.path.join(os.path.dirname(__file__), "_replica_smoke.png")
    r.save_png(out)
    try:
        value, _ = golden_rmse.compare(out, golden_png)
    finally:
        for f in (out, out.replace(".png", "_vs_golden.png")):
            if os.path.exists(f):
                os.remove(f)
    # Margin-tested bound (round 4): three independent 8-spp noise
    # windows at this 48^2 operating point measured 0.1405 / 0.1435 /
    # 0.1503 — the bound sits ~20% above the worst draw, tight enough
    # that a lost object or flipped wall (>= +0.05 at 512^2, more here)
    # fails it, loose enough that Monte-Carlo noise cannot. (The old 0.35
    # bound predated the fitted replica and would have missed real
    # regressions.)
    assert value < 0.18, f"replica drifted from the reference golden: {value}"
