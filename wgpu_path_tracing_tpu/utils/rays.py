"""Ray batches for checking and timing the intersection kernels.

``camera_rays`` gives the coherent frame-0 primary rays of the default
camera; ``scene_rays`` gives incoherent, bounce-like rays: origins uniform
in the scene's root box, directions uniform on the sphere, from a seed.
Both return SoA (3, N) float32 NumPy arrays (origins, directions).
"""

from __future__ import annotations

import numpy as np


def camera_rays(width: int, height: int):
    import jax.numpy as jnp

    from wgpu_path_tracing_tpu.ops import camera_rays as CAM
    from wgpu_path_tracing_tpu.render.camera import Camera
    from wgpu_path_tracing_tpu.render.pipeline import camera_device

    cam = camera_device(
        Camera(width=width, height=height, aspect=width / height).as_pytree(),
        width, height)
    x, y = CAM.pixel_grid(width, height)
    ro, rd, _ = CAM.generate_rays(cam, x, y, jnp.int32(0), use_dof=False)
    return (np.asarray(ro, np.float32).T.copy(),
            np.asarray(rd, np.float32).T.copy())


def scene_rays(bvh_aabb: np.ndarray, n: int, seed: int = 0):
    """``bvh_aabb``: the packed (B, 6) table; row 0 is the root box."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(bvh_aabb[0, 0:3], np.float64)
    hi = np.asarray(bvh_aabb[0, 3:6], np.float64)
    ro = lo[:, None] + rng.uniform(0.02, 0.98, (3, n)) * (hi - lo)[:, None]
    rd = rng.normal(size=(3, n))
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)
