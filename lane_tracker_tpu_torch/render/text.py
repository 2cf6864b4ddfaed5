"""Host-side text annotation.

Copied from lane_tracker_tpu/render/text.py:1-53 (host numpy);
tests/test_torch_host.py pins it equal.  The reference burns curve radius
/ eccentricity / failure text into frames with ``cv2.putText``
(lane_tracker.py:653-659, 668-672).  Annotation never feeds back into
tracking, so it stays off the device: the repository's pre-rasterized
glyph atlas (assets/font.npz, read from the repository, not copied) is
alpha-blitted into numpy frames after the device pipeline returns.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

_ASSET = pathlib.Path(__file__).resolve().parent.parent.parent / "assets" / "font.npz"


@functools.lru_cache(maxsize=1)
def _font():
    with np.load(_ASSET) as z:
        return z["atlas"], z["widths"], int(z["height"]), int(z["first"])


def draw_text(img: np.ndarray, text: str, org, color=(255, 255, 255)) -> np.ndarray:
    """Blit ``text`` onto ``img`` (H, W, 3) uint8, in place; returns img.

    ``org`` is the (x, y) of the text baseline-ish anchor (top-left of the
    glyph box is placed at (x, y - height + 6) to approximate cv2.putText's
    baseline convention).
    """
    atlas, widths, height, first = _font()
    H, W = img.shape[:2]
    x = int(org[0])
    y = int(org[1]) - height + 6
    for ch in text:
        code = ord(ch)
        if not (first <= code < first + atlas.shape[0]):
            code = ord("?")
        g = atlas[code - first]
        w = int(widths[code - first])
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, W), min(y + height, H)
        if x1 > x0 and y1 > y0:
            patch = g[y0 - y : y1 - y, x0 - x : x1 - x].astype(np.float32) / 255.0
            region = img[y0:y1, x0:x1, :].astype(np.float32)
            col = np.asarray(color, np.float32)
            img[y0:y1, x0:x1, :] = (
                region * (1.0 - patch[..., None]) + col * patch[..., None]
            ).astype(np.uint8)
        x += w
    return img
