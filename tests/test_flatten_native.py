"""Bit-identity of the native scene flattener / reorder twins.

accel/cbvh/flatten.cpp must reproduce the NumPy flatten block in
models/gltf.py::load_model and the reorder gathers in
models/assemble.py::finalize_scene EXACTLY (same doubles, same rounding,
no FMA contraction) — the same twin contract bvh_builder.cpp already
carries (tests/test_cbvh.py)."""

import numpy as np
import pytest

from wgpu_path_tracing_tpu.accel import native


pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="native library unavailable")


def _numpy_flatten(pos32, nrm32, world, normal_mat, idx):
    """The models/gltf.py fallback block, verbatim semantics."""
    if np.array_equal(world, np.eye(4)):
        wpos = np.ascontiguousarray(pos32, np.float32)
        nrm64 = nrm32.astype(np.float64)
    else:
        pos = pos32.astype(np.float64)
        wpos = (pos @ world[0:3, 0:3].T + world[0:3, 3]).astype(np.float32)
        nrm64 = nrm32.astype(np.float64) @ normal_mat[0:3, 0:3].T
    ln = np.linalg.norm(nrm64, axis=1, keepdims=True)
    ln[ln == 0] = 1.0
    wnrm = (nrm64 / ln).astype(np.float32)
    i0, i1, i2 = idx[0::3], idx[1::3], idx[2::3]
    return (wpos[i0], wpos[i1], wpos[i2], wnrm[i0], wnrm[i1], wnrm[i2])


@pytest.mark.parametrize("identity", [True, False])
def test_flatten_bit_identical(identity):
    rng = np.random.default_rng(11)
    nv, k = 4096, 6000
    pos = rng.uniform(-50, 50, (nv, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (nv, 3)).astype(np.float32)
    nrm[::97] = 0.0  # zero-length normals pass through (ln==0 -> 1.0)
    idx = rng.integers(0, nv, 3 * k).astype(np.int64)
    if identity:
        world = np.eye(4)
    else:
        world = np.eye(4)
        world[0:3, 0:3] = rng.normal(0, 1, (3, 3)) + np.eye(3) * 2.0
        world[0:3, 3] = rng.uniform(-5, 5, 3)
    normal_mat = np.linalg.inv(world).T

    ref = _numpy_flatten(pos, nrm, world, normal_mat, idx)
    got = native.flatten_native(pos, nrm, world, normal_mat, idx)
    for name, a, b in zip(("v0", "v1", "v2", "n0", "n1", "n2"), ref, got):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_flatten_rejects_bad_index():
    pos = np.zeros((4, 3), np.float32)
    nrm = np.ones((4, 3), np.float32)
    idx = np.array([0, 1, 9], np.int64)  # out of range
    with pytest.raises(RuntimeError):
        native.flatten_native(pos, nrm, np.eye(4), np.eye(4), idx)


def test_reorder_bit_identical():
    rng = np.random.default_rng(12)
    n = 5000
    order = rng.permutation(n).astype(np.int64)
    cols3 = [rng.normal(0, 1, (n, 3)).astype(np.float32) for _ in range(6)]
    cols2 = [rng.normal(0, 1, (n, 2)).astype(np.float32) for _ in range(3)]
    mat = rng.integers(0, 17, n).astype(np.int32)

    got = native.reorder_tris_native(order, *cols3, *cols2, mat)
    for a, b in zip(cols3 + cols2, got[:9]):
        np.testing.assert_array_equal(a[order], b)
    np.testing.assert_array_equal(mat[order], got[9])


def test_load_model_native_matches_numpy(tmp_path, monkeypatch):
    """End-to-end: load_model with the native flattener+reorder vs both
    forced off must produce bit-identical SceneArrays."""
    import wgpu_path_tracing_tpu.models.gltf as gltf_mod
    from wgpu_path_tracing_tpu.models.procedural import material_test_box
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from export_glb import scene_to_glb

    path = str(tmp_path / "scene.glb")
    with open(path, "wb") as f:
        f.write(scene_to_glb(material_test_box()))

    got_native = gltf_mod.load_model(path)
    # Force the NumPy fallbacks: gltf imports native_available at module
    # level; assemble's reorder imports it from accel.native at call time.
    monkeypatch.setattr(gltf_mod, "native_available", lambda: False)
    monkeypatch.setattr(native, "native_available", lambda: False)
    got_numpy = gltf_mod.load_model(path)

    for attr in ("tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
                 "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat"):
        np.testing.assert_array_equal(
            getattr(got_native, attr), getattr(got_numpy, attr),
            err_msg=attr)
