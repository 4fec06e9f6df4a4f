"""Minimal dependency-free PNG writer (stb_image_write equivalent).

The reference exports frames with the vendored stb library
(`reference/include/ui/ui_windows.h:195-210`, with
stbi_flip_vertically_on_write). We emit RGB8 PNGs with zlib from the
stdlib. `write_png` expects rows top-to-bottom; `write_png_bottom_up` flips,
matching the reference's y-up framebuffer convention.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def png_bytes(image: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array (row 0 = top) as PNG bytes."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    raw = b"".join(
        b"\x00" + img[y].tobytes() for y in range(h)
    )
    out = [b"\x89PNG\r\n\x1a\n"]
    out.append(
        _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    )
    out.append(_chunk(b"IDAT", zlib.compress(raw, 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array (row 0 = top) as a PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(image))


def write_png_bottom_up(path: str, image: np.ndarray) -> None:
    """Write an image whose row 0 is the *bottom* scanline (camera v=0)."""
    write_png(path, np.asarray(image)[::-1])


def read_png(path: str) -> np.ndarray:
    """Read back an RGB8 PNG written by write_png (no interlace, filter 0
    or standard filters). Used by tests and the golden harness."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color != 2:
                raise ValueError("only RGB8 supported")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3
    out = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(stride, np.uint8)
    p = 0
    for y in range(h):
        filt = raw[p]
        row = np.frombuffer(raw[p + 1 : p + 1 + stride], np.uint8).copy()
        p += 1 + stride
        if filt == 0:
            pass
        elif filt == 1:  # Sub
            row = row.astype(np.int32)
            for x in range(3, stride):
                row[x] = (row[x] + row[x - 3]) & 0xFF
            row = row.astype(np.uint8)
        elif filt == 2:  # Up
            row = (row.astype(np.int32) + prev) & 0xFF
            row = row.astype(np.uint8)
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        out[y] = row.reshape(w, 3)
        prev = row.astype(np.int32)
    return out
