"""Least times of the main path's kernels, from their shapes.

The peaks and the work counts are frozen copies of chip_smoke.py:328-441
and :2450-2465 (commit 6cc3612; ``bound``, ``morph_ops``, ``tophat_ops``
and the rows' work), counted from the shapes a call takes and independent
of how a kernel does it: each input byte read once, each output byte
written once, the operations at their type's peak rate, and a call's
least time the larger of the two.  NVIDIA H100 SXM data sheet, dense, at
700 W.
"""

from __future__ import annotations

from benchmark.reference.morphology import ellipse_runs

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
I32_OPS_PER_S = F32_OPS_PER_S / 2
OPS_PER_S = {"int32": I32_OPS_PER_S, "int16": 2 * I32_OPS_PER_S,
             "uint8": 4 * I32_OPS_PER_S, "int8": 4 * I32_OPS_PER_S,
             "float32": F32_OPS_PER_S, "bfloat16": 2 * F32_OPS_PER_S}
# Integer operations per pixel (chip_smoke.py:357-368).
THRESHOLD_OPS = 16
NOISE_OPS = 2
MERGE_OPS = 2
PREFIX_OPS = 3
ADAPTIVE_OPS = 10


def bound_s(nbytes, *ops) -> float:
    """The least seconds: the larger of ``nbytes`` at the HBM rate and the
    operations, each ``(count, type)``, at their rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / OPS_PER_S[t] for n, t in ops)
    return max(t_bytes, t_ops)


def morph_ops(k: int) -> int:
    """Operations per pixel of an erode or dilate with the odd k x k
    ellipse: the fewer of the port's two decompositions."""
    runs = ellipse_runs(int(k))
    max_run = max(hi - lo + 1 for _, (lo, hi) in runs)
    pyramid = (max_run.bit_length() - 1) + 2 * len(runs)
    steps, h = 0, 0
    for u in sorted({hi for _, (_, hi) in runs} - {0}):
        while h < u:
            h += min(u - h, 2 * h + 1)
            steps += 1
    return min(pyramid, 2 * steps + len(runs))


def tophat_ops(k: int) -> int:
    return 2 * morph_ops(k) + 1


def attempt1_filter_s(frames: int, H: int, W: int, f: dict) -> float:
    """The 'bilateral' filter stage on ``frames`` (H, W) planes: the
    tophat of R, the tophat of B with its riders, the threshold of B with
    the merge, the open and the packed prefixes."""
    N = frames * H * W
    pref = 4 * frames * H * (W + 1)
    u8, i32 = "uint8", "int32"
    riders = 2 if f["mask_noise"] else 1
    noise = NOISE_OPS if f["mask_noise"] else 0
    return (bound_s(2 * N, (N * tophat_ops(f["tophat_r"]), u8))
            + bound_s((3 + riders) * N,
                      (N * (tophat_ops(f["tophat_b"]) + noise), u8),
                      (N * riders * THRESHOLD_OPS, i32))
            + bound_s((3 + (1 if f["mask_noise"] else 0)) * N + pref,
                      (N * (MERGE_OPS + 2 * morph_ops(f["open_k"])), u8),
                      (N * (THRESHOLD_OPS + PREFIX_OPS), i32)))


def second_filter_s(frames: int, H: int, W: int, open_k: int) -> float:
    """The 'neighborhood' filter stage (no noise mask): two adaptive-mean
    thresholds, the merge, the open and the packed prefixes."""
    N = frames * H * W
    pref = 4 * frames * H * (W + 1)
    return (bound_s(4 * N, (2 * N * ADAPTIVE_OPS, "int32"))
            + bound_s(3 * N + pref,
                      (N * (MERGE_OPS + 2 * morph_ops(open_k)), "uint8"),
                      (N * PREFIX_OPS, "int32")))


def warp_lab_s(frames: int, raw_rows: int, raw_width: int, H: int,
               W: int) -> float:
    """The warp and LAB-B of ``frames``: the raw RGB rows the warp samples
    read once, the warped R and LAB-B planes written once."""
    return bound_s(frames * (raw_rows * raw_width * 3 + 2 * H * W))
