"""Radiance (.hdr / RGBE) image decoder and encoder, and the reference's
tone map, function for function those of the JAX package's ``io/hdr.py``.

The decoder reads the format of the reference's third-party loader
(``src/cpp/lib/hdrloader.cpp:29-191``): the ``#?RADIANCE`` header, 32-bit_rle
RGBE scanlines in both the new-RLE (``decrunch``, ``:118-159``) and old-RLE
(``oldDecrunch``, ``:161-191``) encodings, and the exponent conversion
``c * 2^(e-136)`` (``convertComponent``, ``:99-104``).  ``load_hdr`` reads
through the native library (``io/native.py``, built at first use) as the
JAX package's does, and decodes in Python (``decode_hdr``) only when the
library is turned off (``OCLRT_NATIVE=0``) or reports an error.

``tone_map`` is the reference's exposure curve (``ReadHdrImageData``,
``utility.cpp:172-190``): ``c' = 1 + 1/(-1-c)^5`` (hdrExposure=2), mapping
[0, inf) -> [0, 1); the reference tone-maps every sky it loads.
"""

from __future__ import annotations

import numpy as np


def _convert_scanline(rgbe: np.ndarray) -> np.ndarray:
    """(W,4) uint8 RGBE -> (W,3) f32.  hdrloader.cpp:99-104."""
    expo = rgbe[:, 3].astype(np.int32) - 128
    scale = np.ldexp(np.float32(1.0), expo - 8).astype(np.float32)
    return rgbe[:, :3].astype(np.float32) * scale[:, None]


def _decode_new_rle(data: bytes, pos: int, width: int):
    """New-RLE scanline: 4 component planes, runs >128 / dumps <=128.
    hdrloader.cpp:118-159."""
    out = np.empty((width, 4), np.uint8)
    for comp in range(4):
        x = 0
        while x < width:
            code = data[pos]; pos += 1
            if code > 128:  # run
                out[x:x + code - 128, comp] = data[pos]
                pos += 1
                x += code - 128
            else:           # dump
                out[x:x + code, comp] = np.frombuffer(
                    data, np.uint8, code, pos)
                pos += code
                x += code
    return out, pos


def _decode_old_rle(data: bytes, pos: int, width: int, seeded=None):
    """Old-RLE scanline: (1,1,1,n) repeat codes.  hdrloader.cpp:161-191.

    A repeat code as the very first record references the pixel before the
    scanline — stack garbage in the reference (UB).  We define it as
    (0,0,0,0) instead of copying the UB."""
    out = np.zeros((width, 4), np.uint8)
    x = 0
    rshift = 0
    if seeded is not None:
        out[0] = seeded
        x = 1
    while x < width:
        px = np.frombuffer(data, np.uint8, 4, pos)
        pos += 4
        if px[0] == 1 and px[1] == 1 and px[2] == 1:
            count = int(px[3]) << rshift
            if x > 0:
                out[x:x + count] = out[x - 1]
            x += count
            rshift += 8
        else:
            out[x] = px
            x += 1
            rshift = 0
    return out, pos


def decode_hdr(data: bytes) -> np.ndarray:
    """Decode a Radiance file's bytes -> (H, W, 3) f32 linear RGB."""
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    # Header: lines until blank, then resolution line.
    pos = data.index(b"\n") + 1
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    # Standard orientation "-Y H +X W" (the reference only reads w/h,
    # hdrloader.cpp:63-77).
    h = int(res[1])
    w = int(res[3])

    img = np.empty((h, w, 3), np.float32)
    for y in range(h):
        # The reference's exact fallback ladder (hdrloader.cpp:122-139):
        # 1. width outside [MINELEN=8, MAXELEN=0x7fff] -> old-RLE, nothing
        #    consumed;
        # 2. first byte != 2 -> unread it, old-RLE the whole line;
        # 3. bytes (2, G, B, E) with G != 2 or B & 128 -> that 4-tuple is a
        #    LITERAL first pixel (R forced to 2), old-RLE decodes the
        #    remaining width-1 (mixed-mode seeding);
        # 4. else new-RLE (the encoded length (B<<8)|E is NOT validated
        #    against the width — the reference ignores it).
        if w < 8 or w > 0x7fff:
            rgbe, pos = _decode_old_rle(data, pos, w)
        elif data[pos] != 2:
            rgbe, pos = _decode_old_rle(data, pos, w)
        else:
            px = np.frombuffer(data, np.uint8, 4, pos)
            pos += 4
            if px[1] != 2 or (px[2] & 128):
                seed = np.array([2, px[1], px[2], px[3]], np.uint8)
                rgbe, pos = _decode_old_rle(data, pos, w, seeded=seed)
            else:
                rgbe, pos = _decode_new_rle(data, pos, w)
        img[y] = _convert_scanline(rgbe)
    return img


def load_hdr(path: str) -> np.ndarray:
    """Decode the Radiance file at path -> (H, W, 3) f32 linear RGB, through
    the native decoder unless it returns None."""
    from .native import load_hdr_native
    out = load_hdr_native(path)
    if out is not None:
        return out
    with open(path, "rb") as f:
        return decode_hdr(f.read())


def tone_map(img: np.ndarray, hdr_exposure: int = 2) -> np.ndarray:
    """The reference's exact ad-hoc exposure curve (utility.cpp:180-186)."""
    e = hdr_exposure * 2 + 1
    img = np.asarray(img, np.float32)
    return (1.0 + 1.0 / ((-1.0 - img) ** e)).astype(np.float32)


def encode_hdr(img: np.ndarray) -> bytes:
    """Minimal Radiance writer (flat, non-RLE... new-RLE-free) for tests and
    for shipping a substitute skybox (the reference's is a missing LFS blob,
    .MISSING_LARGE_BLOBS:1)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + \
        f"-Y {h} +X {w}\n".encode()
    maxc = img.max(axis=2)
    expo = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float32)
    nz = maxc > 1e-32
    m, e = np.frexp(maxc[nz])
    expo_nz = e
    scale = np.zeros_like(maxc)
    scale[nz] = m * 256.0 / maxc[nz]
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None] + 0.5, 0,
                            255).astype(np.uint8)
    evals = np.zeros((h, w), np.int32)
    evals[nz] = expo_nz + 128
    rgbe[..., 3] = evals.astype(np.uint8)
    return header + rgbe.tobytes()
