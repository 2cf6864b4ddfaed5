# Frozen copy of lane_tracker_tpu_torch/ops/threshold.py:1-131 (commit 6cc3612),
# the benchmark's plain reference; see benchmark/reference/__init__.py.
"""Adaptive thresholds and ``cv2.inRange`` (plain torch).

Port of lane_tracker_tpu/ops/threshold.py:26-173: the bilateral adaptive
threshold (``bilateral_adaptive_threshold``, both modes; ``cross_threshold``
is its mode 'floor', the one the tracker uses, and the twin of the
cross-threshold kernel), the adaptive mean threshold of the second
attempt's 'neighborhood' filter, and ``in_range`` for the noise mask.  The reference's bilateral threshold
(lane_tracker.py:14-83) passes a pixel iff it beats the mean of BOTH the
left and right arms, or BOTH the up and down arms, of a 1-px cross of
radius ``ksize`` by margin C.  Arm sums come from int32 prefix sums along
each axis (exact), with zeros outside the image.
"""

from __future__ import annotations

import torch


def _arm_sums(x: torch.Tensor, dim: int, k: int):
    """(before, after): sums of the k pixels strictly before/after each
    position along ``dim`` of an int32 tensor; out of range counts 0."""
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = k
    z = x.new_zeros(pad_shape)
    lead = list(x.shape)
    lead[dim] = 1
    padded = torch.cat([x.new_zeros(lead), z, x, z], dim=dim)
    cs = torch.cumsum(padded, dim=dim, dtype=torch.int32)  # cs[i] = sum p[<i]

    def at(start):
        return cs.narrow(dim, start, n)

    # Pixel i sits at padded index i + k (+1 for the leading zero of cs).
    before = at(k) - at(0)
    after = at(2 * k + 1) - at(k + 1)
    return before, after


def _cross_hit(img: torch.Tensor, k: int, C: int, mode: str) -> torch.Tensor:
    """The cross test of a (..., H, W) uint8 image: mode 'floor' passes a
    pixel iff both horizontal arm sums are < k*x - C*k, or both vertical
    ones are; mode 'ceil' iff both are > k*x + C*k."""
    p = img.to(torch.int32)
    left, right = _arm_sums(p, p.dim() - 1, k)
    up, down = _arm_sums(p, p.dim() - 2, k)
    if mode == "floor":
        t = k * p - int(C) * k
        return ((left < t) & (right < t)) | ((up < t) & (down < t))
    t = k * p + int(C) * k
    return ((left > t) & (right > t)) | ((up > t) & (down > t))


def bilateral_adaptive_threshold(img: torch.Tensor, ksize: int = 30,
                                 C: int = 0, mode: str = "floor",
                                 true_value: int = 255,
                                 false_value: int = 0) -> torch.Tensor:
    """The reference's cross-kernel adaptive threshold of a (..., H, W)
    uint8 image (lane_tracker.py:14-83): ``true_value`` where the pixel
    beats the mean of both opposing arms of a 1-px cross of radius
    ``ksize`` by more than C (mode 'floor'; 'ceil' the other way), else
    ``false_value``.  Exact integer sums; equal to the JAX package's int16
    arithmetic wherever that does not wrap (255 k + |C| k < 2^15, k <= 128
    at C = 0).  On CUDA tensors mode 'floor' with 255/0 is the
    cross-threshold kernel (``kernels.filter_stage.bilateral_threshold``),
    at most ``THRESHOLD_MAX_K``."""
    if mode not in ("floor", "ceil"):
        raise ValueError("mode must be 'floor' or 'ceil'")
    k = int(ksize)
    if img.is_cuda and mode == "floor" and (true_value, false_value) == (
            255, 0):
        # Imported here: the kernels' module imports this one.
        from benchmark.reference.filters import (
            bilateral_threshold,
        )

        x = img.reshape((-1,) + img.shape[-2:]).contiguous()
        return bilateral_threshold(x, k, C).reshape(img.shape)
    hit = _cross_hit(img, k, C, mode)
    return torch.where(hit, int(true_value), int(false_value)).to(torch.uint8)


def cross_threshold(img: torch.Tensor, ksize: int, C: int,
                    noise_thresh: int = -1) -> torch.Tensor:
    """Bilateral cross threshold (mode 'floor') of a (..., H, W) uint8
    image: 255 iff both horizontal arm sums are < k*x - C*k, or both
    vertical ones are.  With ``noise_thresh >= 0`` returns the noise
    keep-mask ``(x < noise_thresh) | hit`` instead (the reference's
    ``~inRange(x, noise_thresh, 255) | thr(x)``)."""
    hit = _cross_hit(img, int(ksize), C, "floor")
    if noise_thresh >= 0:
        hit = hit | (in_range(img, noise_thresh, 255) == 0)
    return torch.where(hit, 255, 0).to(torch.uint8)


def _box_mean_replicate(img: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box mean of a (..., H, W) uint8 image with replicate border,
    rounded half to even as OpenCV's cvRound, in int32 integer math."""
    r = (k - 1) // 2
    H, W = img.shape[-2:]
    rows = torch.arange(-r, H + r, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-r, W + r, device=img.device).clamp(0, W - 1)
    padded = img.to(torch.int32)[..., rows, :][..., cols]
    cs = torch.cumsum(torch.cumsum(padded, -2, dtype=torch.int32), -1,
                      dtype=torch.int32)
    # Integral image with a zero row and column prepended.
    integ = torch.nn.functional.pad(cs, (1, 0, 1, 0))
    s = (integ[..., k:k + H, k:k + W] - integ[..., 0:H, k:k + W]
         - integ[..., k:k + H, 0:W] + integ[..., 0:H, 0:W])
    area = k * k
    q = torch.div(s, area, rounding_mode="floor")
    twice = 2 * (s - q * area)
    roundup = (twice > area) | ((twice == area) & (q % 2 == 1))
    return q + roundup.to(torch.int32)


def adaptive_mean_threshold(img: torch.Tensor, ksize: int,
                            C: int) -> torch.Tensor:
    """``cv2.adaptiveThreshold(img, 255, MEAN_C, BINARY, ksize, C)`` of a
    (..., H, W) uint8 image: 255 where ``img - mean > -C`` (OpenCV's
    idelta = ceil(C); every call site passes an int), with the k x k box
    mean over a replicate border."""
    mean = _box_mean_replicate(img, int(ksize))
    hit = img.to(torch.int32) - mean > -int(C)
    return torch.where(hit, 255, 0).to(torch.uint8)


def in_range(img: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``cv2.inRange`` for scalars: 255 where lo <= img <= hi else 0."""
    hit = (img >= lo) & (img <= hi)
    return torch.where(hit, 255, 0).to(torch.uint8)
