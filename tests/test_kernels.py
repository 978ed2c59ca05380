"""The GPU intersection kernels (ops/pallas_kernels.py), run through the
Pallas interpreter on the CPU, against the plain references of
ops/intersect.py; the per-backend kernel choice of make_closest_hit; and
the same kernels compiled on a GPU (marker ``gpu``; skipped elsewhere)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from wgpu_path_tracing_tpu.models.procedural import (
    cornell_box,
    random_triangles,
    single_triangle,
)
from wgpu_path_tracing_tpu.models.types import pack_device_scene
from wgpu_path_tracing_tpu.ops import intersect as I
from wgpu_path_tracing_tpu.ops import pallas_kernels as K
from wgpu_path_tracing_tpu.utils.rays import scene_rays

DENSE_SCENES = {1: lambda: single_triangle(),
                36: lambda: cornell_box(),
                300: lambda: random_triangles(299, seed=3),
                4100: lambda: random_triangles(4099, seed=4)}


def _packed(tris: int):
    return pack_device_scene(DENSE_SCENES[tris]())


def _aimed_rays(tri_isect, n, seed=1, dist=14.0):
    """Rays aimed at random triangle centroids from ``dist`` away."""
    rng = np.random.default_rng(seed)
    tri = np.asarray(tri_isect)
    cent = tri[:, 0:3] + (tri[:, 3:6] + tri[:, 6:9]) / 3.0
    tgt = cent[rng.integers(0, len(tri), n)]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ((tgt - d * dist).T.astype(np.float32),
            d.T.astype(np.float32))


def _spine_tables(n: int = 200):
    """A degenerate spine BVH of depth n over a random soup: interior node
    k holds leaf k (one triangle) on the left and node k + 1 on the right.
    Returns the packed-table subset the intersectors read."""
    from wgpu_path_tracing_tpu.accel.bvh import build_links

    sc = pack_device_scene(random_triangles(n, seed=9))
    tri = sc["tri_isect"]
    v = np.stack([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6],
                  tri[:, 0:3] + tri[:, 6:9]], 1)
    lo, hi = v.min(1), v.max(1)
    meta = np.zeros((2 * n - 1, 4), np.int32)
    aabb = np.zeros((2 * n - 1, 6), np.float32)
    meta[2 * n - 2] = (-1, -1, n - 1, 1)
    aabb[2 * n - 2] = np.concatenate([lo[n - 1], hi[n - 1]])
    for k in range(n - 2, -1, -1):
        meta[2 * k] = (2 * k + 1, 2 * k + 2, 0, 0)
        meta[2 * k + 1] = (-1, -1, k, 1)
        aabb[2 * k + 1] = np.concatenate([lo[k], hi[k]])
        aabb[2 * k, 0:3] = np.minimum(lo[k], aabb[2 * k + 2, 0:3])
        aabb[2 * k, 3:6] = np.maximum(hi[k], aabb[2 * k + 2, 3:6])
    return {"tri_isect": tri, "bvh_aabb": aabb, "bvh_meta": meta,
            "bvh_links": build_links(meta)}


def _assert_within_ulps(a, b, ulps: int = 1):
    """Equal up to ``ulps`` units in the last place (FMA contraction may
    differ between the kernel and XLA's fusion of the reference); an
    infinity (miss) only matches an infinity."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    d = np.abs(a[fin].view(np.int32).astype(np.int64)
               - b[fin].view(np.int32).astype(np.int64))
    assert d.size == 0 or d.max() <= ulps, int(d.max())


@pytest.mark.parametrize("tris", sorted(DENSE_SCENES))
@pytest.mark.parametrize("n", [1, 127, K.DENSE_RAYS, K.DENSE_RAYS + 1, 5000])
def test_dense_kernel_matches_brute(tris, n):
    sc = _packed(tris)
    ro, rd = _aimed_rays(sc["tri_isect"], n, seed=n + tris)
    t_b, i_b = I.closest_hit_brute(sc["tri_isect"], ro.T, rd.T)
    t_k, i_k = K.closest_hit_dense(sc["tri_isect"], ro, rd, interpret=True)
    assert t_k.shape == (n,) and i_k.shape == (n,)
    np.testing.assert_array_equal(np.asarray(i_b), np.asarray(i_k))
    _assert_within_ulps(t_b, t_k)
    assert (np.asarray(i_k) >= 0).any()


@pytest.mark.parametrize("first,second", [(0, 1), (3, 40), (31, 32)])
def test_dense_kernel_first_index_wins_ties(first, second):
    """Two coincident triangles: the lower index wins (strict <,
    pt.wgsl:275), within one kernel step and across steps."""
    tri = np.zeros((48, 9), np.float32)
    tri[:, 0:3] = (100.0, 100.0, 100.0)  # far away, never hit
    tri[:, 3:6] = (1.0, 0.0, 0.0)
    tri[:, 6:9] = (0.0, 1.0, 0.0)
    for i in (first, second):
        tri[i, 0:3] = (-1, -1, -3)
        tri[i, 3:6] = (2, 0, 0)
        tri[i, 6:9] = (1, 2, 0)
    ro = np.zeros((3, 4), np.float32)
    rd = np.tile(np.array([[0.0], [0.0], [-1.0]], np.float32), (1, 4))
    _, idx = K.closest_hit_dense(jnp.asarray(tri), ro, rd, interpret=True)
    np.testing.assert_array_equal(np.asarray(idx), first)
    _, idx_b = I.closest_hit_brute(jnp.asarray(tri), ro.T, rd.T)
    np.testing.assert_array_equal(np.asarray(idx_b), first)


BVH_SCENES = {
    "cornell_tess": lambda: cornell_box(tessellation=5),
    "soup": lambda: random_triangles(1500, seed=5),
    "spine": _spine_tables,
    "single": lambda: single_triangle(),
}


@pytest.fixture(scope="module", params=sorted(BVH_SCENES))
def bvh_scene(request):
    sc = BVH_SCENES[request.param]()
    if request.param != "spine":
        sc = pack_device_scene(sc)
    nodes = np.concatenate([sc["bvh_links"], sc["bvh_meta"][:, 2:4]], 1)
    return request.param, sc, nodes


@pytest.mark.parametrize("mode", ["closest", "any_hit_tmax", "active"])
def test_bvh_kernel_matches_references(bvh_scene, mode):
    """idx exact against the XLA threaded walk (same visit order); against
    brute force equal except the razor-tie class: rays that hit two
    triangles at the same t on a shared edge, where the visit order picks
    the winner."""
    name, sc, nodes = bvh_scene
    n = 700
    ro, rd = _aimed_rays(sc["tri_isect"], n, seed=7)
    rng = np.random.default_rng(11)
    kw = {}
    if mode == "any_hit_tmax":
        kw = dict(t_max=jnp.asarray(rng.uniform(1.0, 20.0, n), jnp.float32),
                  any_hit=True)
    elif mode == "active":
        kw = dict(active=jnp.asarray(rng.uniform(size=n) < 0.6))
    t_k, i_k = K.closest_hit_bvh_kernel(
        sc["bvh_aabb"], nodes, sc["tri_isect"], ro, rd, interpret=True, **kw)
    t_l, i_l = I.closest_hit_bvh_linked(
        sc["bvh_aabb"], nodes, sc["tri_isect"], ro.T, rd.T, **kw)
    t_k, i_k, t_l, i_l = map(np.asarray, (t_k, i_k, t_l, i_l))
    np.testing.assert_array_equal(i_k, i_l)
    _assert_within_ulps(t_k, t_l)
    hit = i_k >= 0
    assert hit.any()
    t_b, i_b = map(np.asarray, I.closest_hit_brute(
        sc["tri_isect"], ro.T, rd.T))
    if mode != "any_hit_tmax":
        act = np.asarray(kw.get("active", np.ones(n, bool)))
        tie = act & (i_k != i_b)
        assert tie.sum() <= 2
        _assert_within_ulps(t_k[act], t_b[act])
        assert (i_k[~act] == -1).all() and np.isinf(t_k[~act]).all()
    else:
        # Any-hit: found exactly where brute force has a hit below t_max.
        below = (i_b >= 0) & (t_b < np.asarray(kw["t_max"]))
        np.testing.assert_array_equal(t_k < np.asarray(kw["t_max"]), below)


def test_bvh_kernel_incoherent_rays_match_walk():
    """Incoherent rays from inside the scene box (bounce-like): exact
    agreement with the XLA threaded walk, ray count off the block size."""
    sc = pack_device_scene(cornell_box(tessellation=3))
    nodes = np.concatenate([sc["bvh_links"], sc["bvh_meta"][:, 2:4]], 1)
    ro, rd = scene_rays(sc["bvh_aabb"], 1000, seed=2)
    t_k, i_k = K.closest_hit_bvh_kernel(
        sc["bvh_aabb"], nodes, sc["tri_isect"], ro, rd, interpret=True)
    t_l, i_l = I.closest_hit_bvh_linked(
        sc["bvh_aabb"], nodes, sc["tri_isect"], ro.T, rd.T)
    np.testing.assert_array_equal(np.asarray(i_k), np.asarray(i_l))
    _assert_within_ulps(t_k, t_l)


SMALL = pack_device_scene(cornell_box())
LARGE = pack_device_scene(cornell_box(tessellation=5))  # 852 tris


@pytest.mark.parametrize("backend,scene,intersector,strategy", [
    ("gpu", "small", "auto", "dense_kernel"),
    ("gpu", "large", "auto", "bvh_kernel"),
    ("gpu", "large", "brute", "dense_kernel"),
    ("gpu", "small", "bvh", "bvh_kernel"),
    ("gpu", "small", "stack", "stack"),
    ("cpu", "small", "auto", "dense_xla"),
    ("cpu", "large", "auto", "bvh_xla"),
    ("cpu", "large", "brute", "dense_xla"),
    ("cpu", "small", "bvh", "bvh_xla"),
    ("cpu", "small", "stack", "stack"),
])
def test_kernel_choice_per_backend(monkeypatch, backend, scene, intersector,
                                   strategy):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    sc = SMALL if scene == "small" else LARGE
    ch = I.make_closest_hit(sc, intersector, brute_max_tris=512, leaf_size=4)
    assert ch.strategy == strategy


@pytest.mark.parametrize("name", ["walk", "walk_hbm", "pairs", "phased",
                                  "cluster"])
def test_removed_intersectors_raise(name):
    from wgpu_path_tracing_tpu.render.config import RenderConfig

    with pytest.raises(ValueError, match="unknown intersector"):
        I.make_closest_hit(SMALL, name, brute_max_tris=512, leaf_size=4)
    with pytest.raises(ValueError, match="unknown intersector"):
        RenderConfig(intersector=name).validate()


def test_gpu_path_uses_kernels(monkeypatch):
    """On ``gpu`` the chosen closures call the Pallas kernels (stubbed
    here: they cannot compile for the CPU)."""
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(K, "closest_hit_dense",
                        lambda tri, ro3, rd3: calls.append("dense") or (0, 0))
    monkeypatch.setattr(K, "closest_hit_bvh_kernel",
                        lambda *a, **kw: calls.append("bvh") or (0, 0))
    ro = jnp.zeros((3, 4), jnp.float32)
    I.make_closest_hit(SMALL, "auto", 512, 4)(ro, ro)
    I.make_closest_hit(LARGE, "auto", 512, 4)(ro, ro)
    assert calls == ["dense", "bvh"]


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest tests -m gpu)")


@pytest.mark.gpu
@pytest.mark.parametrize("tris", [36, 4100])
def test_dense_kernel_compiled_matches_brute(gpu, tris):
    sc = jax.device_put(_packed(tris))
    ro, rd = _aimed_rays(sc["tri_isect"], 1 << 16, seed=tris)
    t_b, i_b = I.closest_hit_brute(sc["tri_isect"], ro.T, rd.T)
    t_k, i_k = K.closest_hit_dense(sc["tri_isect"], ro, rd)
    np.testing.assert_array_equal(np.asarray(i_b), np.asarray(i_k))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["closest", "any_hit_tmax", "active"])
def test_bvh_kernel_compiled_matches_walk(gpu, mode):
    sc = jax.device_put(pack_device_scene(cornell_box(tessellation=20)))
    nodes = jnp.concatenate([sc["bvh_links"], sc["bvh_meta"][:, 2:4]], 1)
    n = 1 << 16
    ro, rd = scene_rays(np.asarray(sc["bvh_aabb"]), n, seed=3)
    rng = np.random.default_rng(5)
    kw = {}
    if mode == "any_hit_tmax":
        kw = dict(t_max=jnp.asarray(rng.uniform(0.1, 2.0, n), jnp.float32),
                  any_hit=True)
    elif mode == "active":
        kw = dict(active=jnp.asarray(rng.uniform(size=n) < 0.6))
    _, i_k = K.closest_hit_bvh_kernel(
        sc["bvh_aabb"], nodes, sc["tri_isect"], ro, rd, **kw)
    _, i_l = I.closest_hit_bvh_linked(
        sc["bvh_aabb"], nodes, sc["tri_isect"], ro.T, rd.T, **kw)
    np.testing.assert_array_equal(np.asarray(i_k), np.asarray(i_l))
