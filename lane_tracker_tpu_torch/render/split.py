"""Split-view composition (debug output).

Copied from lane_tracker_tpu/render/split.py:1-76 (host numpy);
tests/test_torch_host.py pins it equal.  Equivalent of the reference's generic ``create_split_view`` (utils.py:57-103)
and ``LaneTracker.triple_split_view`` (lane_tracker.py:773-793): the
annotated frame on top, the bird's-eye view and the search visualization
scaled side by side below.  Debug-only path — resizing uses a simple
bilinear in numpy (no device round-trip needed).
"""

from __future__ import annotations

import numpy as np


def _resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """Minimal bilinear resize to (width, height) for debug composition."""
    w, h = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    if (W, H) == (w, h):
        return img
    ys = (np.arange(h) + 0.5) * H / h - 0.5
    xs = (np.arange(w) + 0.5) * W / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None]
    fx = np.clip(xs - x0, 0, 1)[None, :]
    if img.ndim == 2:
        img = img[..., None]
    a = img[y0][:, x0].astype(np.float32)
    b = img[y0][:, x1].astype(np.float32)
    c = img[y1][:, x0].astype(np.float32)
    d = img[y1][:, x1].astype(np.float32)
    out = (
        a * (1 - fy)[..., None] * (1 - fx)[..., None]
        + b * (1 - fy)[..., None] * fx[..., None]
        + c * fy[..., None] * (1 - fx)[..., None]
        + d * fy[..., None] * fx[..., None]
    )
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out[..., 0] if out.shape[-1] == 1 else out


def create_split_view(target_size, images, positions, sizes, captions=()):
    """Paste resized images onto a blank canvas (utils.py:57-103 parity)."""
    x_max, y_max = target_size
    canvas = np.zeros((y_max, x_max, 3), dtype=np.uint8)
    for i, img in enumerate(images):
        img = np.asarray(img)
        if img.shape[0] != sizes[i][1] or img.shape[1] != sizes[i][0]:
            img = _resize_bilinear(img, sizes[i])
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        x, y = positions[i]
        w, h = sizes[i]
        canvas[y : min(y + h, y_max), x : min(x + w, x_max), :] = img[
            : min(h, y_max - y), : min(w, x_max - x)
        ]
        if captions and i < len(captions) and captions[i]:
            from lane_tracker_tpu_torch.render.text import draw_text

            draw_text(canvas, str(captions[i]), (x + 10, y + 30))
    return canvas


def triple_split_view(images):
    """Annotated frame on top; bird's-eye + search viz below
    (lane_tracker.py:773-793 layout)."""
    img1_size = (images[0].shape[1], images[0].shape[0])
    img2_size = (images[1].shape[1], images[1].shape[0])
    positions = [(0, 0), (0, img1_size[1]), (round(0.5 * img1_size[0]), img1_size[1])]
    scale = img2_size[0] / (0.5 * img1_size[0])
    scaled = (round(img2_size[0] / scale), round(img2_size[1] / scale))
    target = (img1_size[0], img1_size[1] + scaled[1])
    return create_split_view(target, images, positions, [img1_size, scaled, scaled])
