"""Image output (gamma tone map, BMP and PNG encoders), the OBJ loader and
procedural assets."""

from .bmp import encode_bmp, tonemap_u8, write_bmp
from .obj import load_obj, parse_obj
from .png import encode_png, write_png

__all__ = ["tonemap_u8", "encode_bmp", "write_bmp", "encode_png",
           "write_png", "parse_obj", "load_obj"]
