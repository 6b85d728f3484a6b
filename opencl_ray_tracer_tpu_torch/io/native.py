"""ctypes bindings to the native C++ IO library, ``io/csrc/oclrt_native.cpp``.

The reference's asset-ingestion layer is native C++ (``utility.cpp`` OBJ
parsing, ``hdrloader.cpp`` RGBE decoding, ``bitmap_io.cpp`` BMP encoding);
this module binds the port's copy of the JAX package's C++ equivalents,
function for function that package's ``io/native.py``.  The library is
compiled with the host compiler at first use into ``_build/``
(``kernels/_build.py::build_host``), never when a module is imported; a
failed build raises with the compiler's errors.  ``OCLRT_NATIVE=0`` turns
the library off: each loader then returns None (``write_bmp_native``
False), as it does when the library reports an error (a missing file, a
malformed one), and ``io/obj.py`` and ``io/hdr.py`` parse in Python.
"""

from __future__ import annotations

import ctypes
import os
import pathlib

import numpy as np

SOURCE = pathlib.Path(__file__).parent / "csrc" / "oclrt_native.cpp"
_LIB = None


def _lib():
    """The library, built and bound at the first call; None when
    ``OCLRT_NATIVE`` is 0."""
    global _LIB
    if os.environ.get("OCLRT_NATIVE", "1") == "0":
        return None
    if _LIB is None:
        from ..kernels import _build
        lib = ctypes.CDLL(str(_build.build_host(SOURCE)))
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.oclrt_load_obj.restype = ctypes.c_int
        lib.oclrt_load_obj.argtypes = [
            ctypes.c_char_p,                 # path
            f32p,                            # scale[3]
            f32p,                            # translate[3]
            ctypes.POINTER(f32p),            # out tris
            ctypes.POINTER(ctypes.c_int),    # out n_tris
            f32p,                            # out aabb[6]
        ]
        lib.oclrt_free.restype = None
        lib.oclrt_free.argtypes = [ctypes.c_void_p]
        lib.oclrt_load_hdr.restype = ctypes.c_int
        lib.oclrt_load_hdr.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(f32p),
            ctypes.POINTER(ctypes.c_int),    # w
            ctypes.POINTER(ctypes.c_int),    # h
        ]
        lib.oclrt_write_bmp.restype = ctypes.c_int
        lib.oclrt_write_bmp.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int,
        ]
        _LIB = lib
    return _LIB


def load_obj_native(path, scale, translate):
    """The OBJ file at ``path`` under ``scale`` and ``translate``: ((T,3,3)
    f32 triangles, (min(3,), max(3,)) f32 AABB), as ``io.obj.parse_obj``;
    None when the library is off or reports an error."""
    lib = _lib()
    if lib is None:
        return None
    s = (ctypes.c_float * 3)(*[float(x) for x in scale])
    t = (ctypes.c_float * 3)(*[float(x) for x in translate])
    tris_ptr = ctypes.POINTER(ctypes.c_float)()
    n_tris = ctypes.c_int(0)
    aabb = (ctypes.c_float * 6)()
    rc = lib.oclrt_load_obj(os.fsencode(path), s, t, ctypes.byref(tris_ptr),
                            ctypes.byref(n_tris), aabb)
    if rc != 0:
        return None
    n = n_tris.value
    tris = np.ctypeslib.as_array(tris_ptr, shape=(n, 3, 3)).copy()
    lib.oclrt_free(tris_ptr)
    return tris, (np.array(aabb[0:3], np.float32),
                  np.array(aabb[3:6], np.float32))


def load_hdr_native(path):
    """The Radiance file at ``path``: (H, W, 3) f32 linear RGB, as
    ``io.hdr.decode_hdr``; None when the library is off or reports an
    error."""
    lib = _lib()
    if lib is None:
        return None
    img_ptr = ctypes.POINTER(ctypes.c_float)()
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.oclrt_load_hdr(os.fsencode(path), ctypes.byref(img_ptr),
                            ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    img = np.ctypeslib.as_array(img_ptr, shape=(h.value, w.value, 3)).copy()
    lib.oclrt_free(img_ptr)
    return img


def write_bmp_native(path, img_u8) -> bool:
    """Write the (H, W, 3) uint8 image as the BMP of ``io.bmp.encode_bmp``;
    False when the library is off or reports an error."""
    lib = _lib()
    if lib is None:
        return False
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, _ = img_u8.shape
    rc = lib.oclrt_write_bmp(
        os.fsencode(path),
        img_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h)
    return rc == 0
