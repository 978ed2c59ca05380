"""cornell.glb replica (models/replica.py): scene construction sanity.

The replica exists to measure RMSE against the reference's golden
(docs/img/cornell_512spp.png) whose source scene is stripped from the
mirror; these tests only cover that the reconstruction builds and renders
finite — tools/golden_rmse.py measures the RMSE itself.
"""

import os

import numpy as np
import pytest

from wgpu_path_tracing_tpu import Renderer, RenderConfig
from wgpu_path_tracing_tpu.models.replica import cornell_replica, icosphere


def test_icosphere_geometry():
    v0, v1, v2, n0, n1, n2 = icosphere((1.0, 2.0, 3.0), 0.5, subdivisions=2)
    assert len(v0) == 20 * 4**2
    c = np.asarray([1.0, 2.0, 3.0])
    for v in (v0, v1, v2):
        np.testing.assert_allclose(
            np.linalg.norm(v - c, axis=1), 0.5, rtol=1e-6
        )
    # Smooth normals point radially outward.
    np.testing.assert_allclose(
        n0, (v0 - c) / 0.5, rtol=1e-5, atol=1e-6
    )


def test_replica_builds_and_renders():
    sc = cornell_replica(include_monkey=False, pad_to=8192)
    assert sc.num_triangles == 8192  # shape-stable padding
    assert sc.num_lights == 2  # the two emissive ceiling triangles
    assert (sc.mat_transmission > 0).sum() == 1  # the glass sphere
    r = Renderer(RenderConfig(width=32, height=32, frames_per_chunk=2,
                              max_bounces=4))
    r.load_scene(sc)
    out = r.render(spp=2)
    assert np.isfinite(out).all()
    assert out.max() > 0


@pytest.mark.skipif(
    not os.path.exists("/root/reference/public/models/monkey.glb"),
    reason="reference mirror not available",
)
def test_replica_includes_monkey():
    base = cornell_replica(include_monkey=False)
    full = cornell_replica(include_monkey=True)
    assert full.num_triangles > base.num_triangles + 500  # Suzanne is there
