"""Set-up pieces the GPU runs depend on: the stdlib PNG codec, the
compile-cache directory rule, and the device-time reduction of a profiler
trace (utils/devtrace.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wgpu_path_tracing_tpu.utils import cache, devtrace
from wgpu_path_tracing_tpu.utils import image as imageio

GOLDEN_PNG = os.path.join(os.path.dirname(__file__), "goldens",
                          "cornell_48x48_8spp.png")


@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 23, 3), (64, 3, 4),
                                   (5, 300, 3)])
def test_png_codec_round_trip(shape):
    px = np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(imageio.decode_png(imageio.encode_png(px)),
                                  px)


def test_png_write_read_float(tmp_path):
    img = np.random.default_rng(0).uniform(size=(9, 11, 3))
    path = str(tmp_path / "x.png")
    imageio.write_png(path, img)
    got = imageio.read_png(path)
    np.testing.assert_array_equal(
        np.round(got * 255), (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))


@pytest.mark.parametrize("ftype", [1, 2, 3, 4])
def test_png_decodes_every_filter_type(ftype):
    """Rows stored with the Sub/Up/Average/Paeth filters (as other
    encoders write them) decode to the original pixels."""
    import struct
    import zlib

    px = np.random.default_rng(ftype).integers(0, 256, (6, 5, 3),
                                               dtype=np.uint8)
    bpp, rows = 3, []
    prev = np.zeros(15, np.int64)
    for y in range(6):
        cur = px[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 6, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))
    np.testing.assert_array_equal(imageio.decode_png(data), px)


def test_png_reads_committed_golden():
    img = imageio.read_png(GOLDEN_PNG)
    assert img.shape == (48, 48, 3)
    assert 0.0 <= img.min() and img.max() <= 1.0 and img.max() > 0.5


def test_png_rejects_garbage():
    with pytest.raises(ValueError, match="PNG"):
        imageio.decode_png(b"not a png at all")


def test_compile_cache_env_wins(monkeypatch):
    monkeypatch.setenv(cache.CACHE_ENV, "/some/where")
    assert cache.compile_cache_dir() == "/some/where"
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before  # untouched


def test_compile_cache_default_is_checkout_root(monkeypatch):
    monkeypatch.delenv(cache.CACHE_ENV, raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.DEFAULT_CACHE_DIR == os.path.join(root, ".jax_cache")
    assert cache.enable_compile_cache() == cache.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_CACHE_DIR


def test_devtrace_busy_merges_overlaps():
    ev = [devtrace.DeviceEvent("closest_hit_dense", 0.0, 10e6),
          devtrace.DeviceEvent("fusion.1", 5e6, 10e6),  # overlaps
          devtrace.DeviceEvent("fusion.2", 6e6, 1e6),  # nested
          devtrace.DeviceEvent("closest_hit_dense", 30e6, 2e6)]
    assert devtrace.busy_ms(ev) == pytest.approx(17.0)


def test_devtrace_raises_without_device_plane():
    """On the CPU the trace holds no GPU device plane: the reduction must
    refuse rather than report host time as device time."""
    x = jnp.ones((64, 64))
    with pytest.raises(RuntimeError, match="no GPU device events"):
        devtrace.trace_device(lambda: jax.block_until_ready(x @ x))
