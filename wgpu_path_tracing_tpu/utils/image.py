"""Image output and comparison utilities.

The reference displays through a canvas blit (blit.wgsl); headless, we write
PNGs (a stdlib zlib/struct codec, no imaging library needed). The accumulation buffer's row 0 is the BOTTOM of the view (see
ops/camera_rays.py and blit.wgsl:149-151's y-flip), so PNG writing flips
vertically to match what the reference shows on screen (and its goldens under
docs/img/).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def buffer_to_srgb(accum: np.ndarray, width: int, height: int, exposure: float = 1.0):
    """HDR accumulation (N, 3) -> display-referred (H, W, 3) float in [0,1],
    top row first."""
    from wgpu_path_tracing_tpu.ops import tonemap

    img = np.asarray(tonemap.display_transform(accum.reshape(height, width, 3),
                                               exposure))
    img = np.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    img = np.clip(img, 0.0, 1.0)
    return img[::-1]  # buffer row 0 is the bottom of the view


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W, 4) uint8, top row first -> PNG bytes (8-bit,
    filter type 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    color_type = {3: 2, 4: 6}[c]
    raw = np.zeros((h, 1 + w * c), np.uint8)
    raw[:, 1:] = rgb.reshape(h, w * c)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_PNG_MAGIC + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def _unfilter(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int):
    """Reverse one PNG scanline filter (RFC 2083 §6) in place on ``line``."""
    if ftype == 0:
        return line
    if ftype == 2:
        return (line + prev).astype(np.uint8)
    if ftype == 1:  # Sub: running sum per channel, mod 256
        px = line.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) % 256).astype(np.uint8).reshape(-1)
    out = line.astype(np.int64)
    up = prev.astype(np.int64)
    for i in range(out.size):
        left = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            out[i] = (out[i] + (left + up[i]) // 2) % 256
        elif ftype == 4:
            ul = up[i - bpp] if i >= bpp else 0
            p = left + up[i] - ul
            pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
            pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
            out[i] = (out[i] + pred) % 256
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 (C = 1, 2, 3 or 4 as stored).

    Supports the non-interlaced 8-bit gray / gray+alpha / RGB / RGBA
    files this package and common tools write."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG file (bad magic)")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = hdr
    channels = {0: 1, 4: 2, 2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color_type}, "
            f"interlace {interlace}): only non-interlaced 8-bit gray, "
            "gray+alpha, RGB and RGBA are read")
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + stride)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, channels)
    return out.reshape(h, w, channels)


def write_png(path: str, img01: np.ndarray) -> None:
    """img01: (H, W, 3) float in [0, 1], top row first."""
    data = (np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(data))


def read_png(path: str) -> np.ndarray:
    """PNG file -> (H, W, 3) float32 in [0, 1] (gray expanded, alpha
    dropped)."""
    with open(path, "rb") as f:
        px = decode_png(f.read())
    if px.shape[2] <= 2:
        px = np.repeat(px[..., :1], 3, axis=2)
    return px[..., :3].astype(np.float32) / 255.0


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error between two [0,1] images of equal shape."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def write_hdr(path: str, hdr: np.ndarray) -> None:
    """Write a Radiance RGBE .hdr file (linear HDR, no tonemap).

    hdr: (H, W, 3) float32 linear radiance, top row first. The headless
    analog of the reference's HDR canvas path (rgba16float +
    toneMapping 'standard', renderer.ts:535-541): downstream tools apply
    their own display transform. Flat (uncompressed) scanlines.
    """
    hdr = np.asarray(hdr, np.float32)
    h, w = hdr.shape[0], hdr.shape[1]
    maxc = np.maximum(hdr.max(axis=2), 1e-32)
    exp = np.ceil(np.log2(maxc)).astype(np.int32) + 1
    scale = np.exp2(exp.astype(np.float32) - 8.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    mantissa = np.clip(hdr / scale[..., None] + 0.5, 0.0, 255.0).astype(np.uint8)
    rgbe[..., 0:3] = mantissa
    rgbe[..., 3] = np.clip(exp + 128, 0, 255).astype(np.uint8)
    zero = maxc <= 1e-32
    rgbe[zero] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def write_exr(path: str, hdr: np.ndarray) -> None:
    """Write an OpenEXR 2.0 file (uncompressed FLOAT scanlines, R/G/B).

    hdr: (H, W, 3) float32 linear radiance, top row first. Like
    ``write_hdr`` this is a headless extension past the reference's canvas
    display (renderer.ts:535-541) for DCC interchange; EXR stores exact
    f32 so round trips are lossless (unlike RGBE's shared exponent).
    Self-contained: emits the minimal required header attribute set with
    NO_COMPRESSION, one scanline per chunk, channels in the alphabetical
    order (B, G, R) the format mandates.
    """
    import struct

    hdr = np.ascontiguousarray(np.asarray(hdr, np.float32))
    h, w = hdr.shape[0], hdr.shape[1]

    def attr(name: bytes, typ: bytes, payload: bytes) -> bytes:
        return name + b"\0" + typ + b"\0" + struct.pack("<i", len(payload)) + payload

    # chlist: per channel: name\0, pixel type (2=FLOAT), pLinear+pad, x/y sampling.
    ch = b""
    for name in (b"B", b"G", b"R"):
        ch += name + b"\0" + struct.pack("<i", 2) + b"\0\0\0\0" + struct.pack("<ii", 1, 1)
    ch += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<I", 20000630)  # magic
        + struct.pack("<i", 2)  # version 2, scanline
        + attr(b"channels", b"chlist", ch)
        + attr(b"compression", b"compression", b"\0")  # NO_COMPRESSION
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\0")  # INCREASING_Y
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\0"
    )
    line_bytes = 4 * w * 3  # 3 FLOAT channels
    chunk_bytes = 8 + line_bytes  # y + size prefix
    table_at = len(header)
    data_at = table_at + 8 * h
    offsets = struct.pack("<" + "Q" * h, *(data_at + y * chunk_bytes for y in range(h)))
    with open(path, "wb") as f:
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, line_bytes))
            f.write(hdr[y, :, 2].tobytes())  # B
            f.write(hdr[y, :, 1].tobytes())  # G
            f.write(hdr[y, :, 0].tobytes())  # R


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed FLOAT-scanline OpenEXR (as written by
    ``write_exr``) -> (H, W, 3) f32, top row first.

    Only the NO_COMPRESSION + FLOAT-channel subset is supported; real-world
    EXRs (ZIP/PIZ-compressed, HALF channels — the common case for downloaded
    HDRIs) raise ValueError naming the limitation. Convert such files to
    Radiance .hdr (read_hdr) or uncompressed FLOAT first."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<Ii", data, 0)
    if magic != 20000630:
        raise ValueError(f"{path}: not an EXR file (bad magic)")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        nend = data.index(b"\0", pos)
        name = data[pos:nend].decode()
        tend = data.index(b"\0", nend + 1)
        (size,) = struct.unpack_from("<i", data, tend + 1)
        val = data[tend + 5 : tend + 5 + size]
        attrs[name] = val
        pos = tend + 5 + size
    pos += 1  # header terminator
    if attrs.get("compression", b"?") != b"\0":
        raise ValueError(
            f"{path}: only uncompressed (NO_COMPRESSION) FLOAT-scanline EXRs "
            "are supported — ZIP/PIZ-compressed or HALF-channel EXRs must be "
            "converted first (e.g. to Radiance .hdr)")
    chlist, cpos = attrs.get("channels", b"\0"), 0
    while chlist[cpos] != 0:  # per channel: name\0 i32 type, 4B flags, 2xi32
        cend = chlist.index(b"\0", cpos)
        (ctype,) = struct.unpack_from("<i", chlist, cend + 1)
        if ctype != 2:  # 0=UINT, 1=HALF, 2=FLOAT
            raise ValueError(
                f"{path}: channel {chlist[cpos:cend].decode()!r} is not FLOAT"
                " — HALF/UINT EXRs must be converted to uncompressed FLOAT "
                "or Radiance .hdr first")
        cpos = cend + 17
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    offsets = struct.unpack_from("<" + "Q" * h, data, pos)
    out = np.empty((h, w, 3), np.float32)
    for row, off in enumerate(offsets):
        y, size = struct.unpack_from("<ii", data, off)
        if size != 12 * w:
            raise ValueError(
                f"{path}: scanline {row} has {size} bytes, expected {12 * w} "
                "(multi-channel or tiled EXRs are not supported)")
        line = np.frombuffer(data, np.float32, count=3 * w, offset=off + 8)
        out[y - y0, :, 2] = line[0:w]  # B
        out[y - y0, :, 1] = line[w : 2 * w]  # G
        out[y - y0, :, 0] = line[2 * w :]  # R
    return out


def read_hdr(path: str) -> np.ndarray:
    """Read a flat (uncompressed) Radiance RGBE .hdr file -> (H, W, 3) f32."""
    with open(path, "rb") as f:
        data = f.read()
    head, _, rest = data.partition(b"\n\n")
    if not data.startswith(b"#?RADIANCE"):
        raise ValueError(f"{path}: not a Radiance .hdr file (bad magic)")
    dims, _, pix = rest.partition(b"\n")
    parts = dims.split()
    h, w = int(parts[1]), int(parts[3])
    rgbe = np.frombuffer(pix, np.uint8, count=h * w * 4).reshape(h, w, 4)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.exp2(exp - 128 - 8, dtype=np.float64))
    return (rgbe[..., 0:3].astype(np.float32) * scale[..., None].astype(np.float32))
