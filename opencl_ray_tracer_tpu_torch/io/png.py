"""Minimal dependency-free PNG writer (the reference writes only BMP; see
bmp.py for the bit-compatible path)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .bmp import _to_numpy


def encode_png(img_u8, bottom_up: bool = True) -> bytes:
    """(H,W,3) uint8 RGB -> PNG bytes.  bottom_up=True means row 0 is the
    image bottom (the tracer's convention) and is flipped for display."""
    img = _to_numpy(img_u8).astype(np.uint8)
    if bottom_up:
        img = img[::-1]
    h, w, _ = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img_u8, bottom_up: bool = True) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img_u8, bottom_up))
