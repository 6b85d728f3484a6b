"""Image output (gamma tone map, BMP and PNG encoders) and the BMP reader,
the OBJ loader, the Radiance HDR decoder and encoder with the reference's
tone map, and procedural assets.  ``load_obj`` and ``load_hdr`` read
through the native C++ library (``native.py``, built with g++ at first
use) and parse in Python when it is turned off."""

from .bmp import encode_bmp, read_bmp, tonemap_u8, write_bmp
from .hdr import decode_hdr, encode_hdr, load_hdr, tone_map
from .obj import load_obj, parse_obj
from .png import encode_png, write_png

__all__ = ["tonemap_u8", "encode_bmp", "write_bmp", "read_bmp",
           "encode_png", "write_png", "parse_obj", "load_obj", "decode_hdr", "load_hdr",
           "tone_map", "encode_hdr"]
