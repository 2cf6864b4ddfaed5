"""OpenCV-exact uint8 LAB of uint8 RGB: the LUT path and the fast path.

Port of ``rgb2lab_u8`` and ``rgb2lab_b_u8`` (lane_tracker_tpu/ops/
color.py:84-120, 271-290; the 'compat' pipeline's LUT chain, integer
throughout, so bit-exact) and ``rgb2lab_b_fast`` (color.py:212-268).
``_tables`` and the LP-certified gamma polynomial are copied from the same
file (lines 40-77, 122-209); tests/test_torch_color_warp.py pins both.

The reference evaluates OpenCV's fixed-point Lab pipeline in f32: gamma by
a degree-12 polynomial whose rint equals OpenCV's gamma table on all 256
inputs under any FMA order, then the XYZ rows and descales in exact f32
integer math, then ``rint(2^15 * cbrt(t))`` for t = idx / 2040 with idx an
integer in [0, 3071].  That last step takes only 3072 distinct values, and
``cbrt_tab`` holds exactly them, so the port gathers from the table: the
card's ``cbrtf`` rounding never enters.  The XYZ rows and descales run in
int32, which is exact wherever the reference's f32 is (all < 2^24).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lane_tracker_tpu_torch.ops import f32

_LAB_SHIFT = 12
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT  # 15
_GAMMA_TAB_SIZE = 256
_CBRT_TAB_SIZE = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)  # 3072

_D65 = (0.950456, 1.0, 1.088754)
_XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)


def _round_half_even(x):
    return np.rint(x).astype(np.int64)


@functools.lru_cache(maxsize=1)
def _tables():
    # sRGB linearization LUT, computed in float32 like OpenCV's softfloat init.
    i = np.arange(_GAMMA_TAB_SIZE, dtype=np.float32)
    x = (i / np.float32(255.0)).astype(np.float32)
    lo = (x / np.float32(12.92)).astype(np.float32)
    hi = (((x + np.float32(0.055)) / np.float32(1.055)) ** np.float32(2.4)).astype(
        np.float32
    )
    gamma = np.where(x <= np.float32(0.04045), lo, hi)
    gamma_tab = _round_half_even(
        (np.float32(255.0 * (1 << _GAMMA_SHIFT)) * gamma).astype(np.float32)
    ).astype(np.int32)

    # Cube-root LUT with the CIE linear segment below 0.008856.
    t = (
        np.arange(_CBRT_TAB_SIZE, dtype=np.float32)
        * (np.float32(1.0) / np.float32(255.0 * (1 << _GAMMA_SHIFT)))
    ).astype(np.float32)
    cbrt = np.where(
        t < np.float32(0.008856),
        t * np.float32(7.787) + np.float32(0.13793103448275862),
        np.cbrt(t, dtype=np.float32),
    )
    cbrt_tab = _round_half_even(
        (np.float32(1 << _LAB_SHIFT2) * cbrt).astype(np.float32)
    ).astype(np.int32)

    coeffs = np.zeros((3, 3), dtype=np.int32)
    for r in range(3):
        for c in range(3):
            coeffs[r, c] = _round_half_even(
                np.float64(
                    np.float32(_XYZ[r][c])
                    / np.float32(_D65[r])
                    * np.float32(1 << _LAB_SHIFT)
                )
            )
    return gamma_tab, cbrt_tab, coeffs


# LP-certified gamma polynomial (degree 12, Chebyshev-center LP): its f32
# Horner rint reproduces gamma_tab on every power-branch input i in
# [11, 255] with margin 0.021, under either FMA contraction choice.
# u = (i - mid) / half, coefficients highest-first.
_GAMMA_POLY_MID = 133.0
_GAMMA_POLY_HALF = 122.0
_GAMMA_POLY_COEFS = (
    -44.081208940021156,
    -35.0394862240723,
    105.81190372931691,
    86.91622624219376,
    -88.51931702132121,
    -76.8666569982063,
    29.323830599210154,
    31.640361529067718,
    -11.53070519185922,
    56.55635092162949,
    553.7077317661957,
    953.1224678867455,
    478.4792508505659,
)


def _gamma_poly_f32(x: torch.Tensor) -> torch.Tensor:
    """rint(255*8*gamma(i/255)) == gamma_tab[i] for integer-valued f32 i
    in [0, 255] (ops/color.py:212-222 of the reference)."""
    u = (x - f32(_GAMMA_POLY_MID)) * f32(1.0 / _GAMMA_POLY_HALF)
    acc = torch.full_like(u, f32(_GAMMA_POLY_COEFS[0]))
    for c in _GAMMA_POLY_COEFS[1:]:
        acc = acc * u + f32(c)
    lin = torch.round(x * f32(8.0 / 12.92))
    return torch.where(x <= f32(255.0 * 0.04045), lin, torch.round(acc))


@functools.lru_cache(maxsize=8)
def _cbrt_table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_tables()[1], dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=8)
def _gamma_table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_tables()[0], dtype=torch.int32, device=device)


def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v + (1 << (n - 1))) >> n


def _lut_f(img: torch.Tensor, rows):
    """The cube-root LUT values f(X), f(Y), f(Z) of ``rows`` for uint8
    RGB, by the reference's integer LUT chain (color.py:92-103)."""
    gamma = _gamma_table(img.device)
    cbrt = _cbrt_table(img.device)
    rgb = gamma[img.long()]
    R, G, B = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    C = _tables()[2]
    out = []
    for row in rows:
        acc = R * int(C[row, 0]) + G * int(C[row, 1]) + B * int(C[row, 2])
        idx = _descale(acc, _LAB_SHIFT).clamp_(0, _CBRT_TAB_SIZE - 1)
        out.append(cbrt[idx.long()])
    return out


def rgb2lab_u8(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (..., 3) OpenCV-exact uint8 LAB."""
    fX, fY, fZ = _lut_f(img, (0, 1, 2))
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    L = _descale(l_scale * fY + l_shift, _LAB_SHIFT2)
    a = _descale(500 * (fX - fY) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    b = _descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([L, a, b], dim=-1).clamp_(0, 255).to(torch.uint8)


def rgb2lab_b_u8(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (...) uint8 LAB B-channel by the LUT chain
    (the 'compat' pipeline's, lane_tracker.py:208)."""
    fY, fZ = _lut_f(img, (1, 2))
    b = _descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return b.clamp_(0, 255).to(torch.uint8)


def rgb2lab_b_fast(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (...) uint8 LAB B-channel, bit-exact with the
    reference's ``rgb2lab_b_fast``."""
    g = _gamma_poly_f32(img.float()).to(torch.int32)
    R, G, B = g[..., 0], g[..., 1], g[..., 2]
    C = _tables()[2]
    tab = _cbrt_table(img.device)

    def f(row):
        acc = R * int(C[row, 0]) + G * int(C[row, 1]) + B * int(C[row, 2])
        idx = ((acc + (1 << (_LAB_SHIFT - 1))) >> _LAB_SHIFT).clamp_(
            0, _CBRT_TAB_SIZE - 1)
        return tab[idx]

    fY, fZ = f(1), f(2)
    b = (200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2)
         + (1 << (_LAB_SHIFT2 - 1))) >> _LAB_SHIFT2
    return b.clamp_(0, 255).to(torch.uint8)
