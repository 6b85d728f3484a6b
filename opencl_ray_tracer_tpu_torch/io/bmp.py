"""24-bit BMP writer, bit-compatible with the reference encoder
(``src/cpp/bitmap_io.cpp:3-84``): 14-byte file header, 40-byte
BITMAPINFOHEADER, bottom-up rows, BGR order, rows padded to 4 bytes.  With
``tonemap_u8`` (the gamma-2.0 ``WriteColour`` math, ``colour.cpp:5-15``)
this gives the reference's ``output.bmp`` bytes for the same radiance."""

from __future__ import annotations

import struct

import numpy as np
import torch


def _to_numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return np.asarray(img)


def tonemap_u8(img) -> np.ndarray:
    """Radiance in [0,1] -> uint8 with gamma 2.0 (colour.cpp:8-10).
    img: (H,W,3) tensor or array, row 0 = image bottom.  The cast
    truncates, as the C ``(unsigned char)`` conversion does."""
    img = _to_numpy(img).astype(np.float32)
    return (np.sqrt(np.clip(img, 0.0, 1.0)) * 255.0).astype(np.uint8)


def encode_bmp(img_u8) -> bytes:
    """(H,W,3) uint8 RGB, row 0 = bottom -> BMP bytes (row 0 written
    first, as bitmap_io.cpp:22-26 does)."""
    img_u8 = _to_numpy(img_u8)
    h, w, _ = img_u8.shape
    row_bytes = w * 3
    pad = (4 - row_bytes % 4) % 4
    stride = row_bytes + pad
    file_header_size, info_header_size = 14, 40
    file_size = file_header_size + info_header_size + stride * h
    out = bytearray()
    out += struct.pack("<2sIHHI", b"BM", file_size, 0, 0,
                       file_header_size + info_header_size)
    out += struct.pack("<IiiHHIIiiII", info_header_size, w, h, 1, 24,
                       0, 0, 0, 0, 0, 0)
    bgr = img_u8[:, :, ::-1]  # BGR order (colour.cpp:12-14)
    padding = b"\x00" * pad
    for y in range(h):
        out += bgr[y].tobytes() + padding
    return bytes(out)


def write_bmp(path: str, img) -> None:
    """Tone-map a radiance image (``tonemap_u8``) and write it as BMP."""
    with open(path, "wb") as f:
        f.write(encode_bmp(tonemap_u8(img)))
