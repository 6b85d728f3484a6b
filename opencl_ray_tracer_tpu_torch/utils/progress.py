"""Render progress reporting.

Takes the place of the reference's ``\\r`` progress line (``main.cpp:267``)
and of the full-frame BMP it rewrites after every block for its window to
poll (``main.cpp:263-265``): a callback that prints progress and writes the
image so far, as BMP for a ``.bmp`` path and PNG otherwise, which any image
viewer can watch.
"""

from __future__ import annotations

import sys
import time


class ProgressReporter:
    """``progress(done, total, mean_img)`` for ``render(progress=)`` and
    ``parallel.render_checkpointed``: prints "Rendered done / total" and
    writes mean_img ((H, W, 3) radiance, a tensor on any device or an
    array) to ``image_path`` at most every ``every_s`` seconds and at the
    end.  The image leaves the device only when it is written."""

    def __init__(self, image_path: str | None = None, every_s: float = 1.0,
                 stream=None):
        self.image_path = image_path
        self.every_s = every_s
        self.stream = stream or sys.stderr
        self._last_dump = 0.0

    def __call__(self, done: int, total: int, mean_img=None) -> None:
        pct = 100.0 * done / max(total, 1)
        self.stream.write(f"\rRendered {done} / {total} samples "
                          f"({pct:.0f}%)")
        if done >= total:
            self.stream.write("\n")
        self.stream.flush()
        now = time.time()
        if (self.image_path and mean_img is not None
                and (now - self._last_dump >= self.every_s or done >= total)):
            if self.image_path.endswith(".bmp"):
                from ..io import write_bmp
                write_bmp(self.image_path, mean_img)
            else:
                from ..io import tonemap_u8, write_png
                write_png(self.image_path, tonemap_u8(mean_img))
            self._last_dump = now
