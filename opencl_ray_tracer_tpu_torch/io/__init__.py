"""Image output: gamma tone map, BMP and PNG encoders."""

from .bmp import encode_bmp, tonemap_u8, write_bmp
from .png import encode_png, write_png

__all__ = ["tonemap_u8", "encode_bmp", "write_bmp", "encode_png",
           "write_png"]
