"""Probe 6's kernel: bf16 sweeps beside tensor-core dots, wrapper and twin.

Port of the Pallas kernel ``make(kind)`` of scripts/mosaic_probe6.py (:35),
which asks whether a kernel's matrix products run beside its vector sweeps.
Per frame t of x (T, R, C) bf16 a scratch starts as x[t]; kind ``sweeps``
or ``both`` runs ``sweeps`` sweeps ``scr[0:R-8] = bf16(min(scr[0:R-8],
scr[d:d+R-8]) + 1)``, d = i % 7 + 1 (the add in f32, rounded once; rows
R-8.. never change); kind ``dots`` or ``both`` sums the three bf16 products
``scr[8j:8j+block, col0:col0+KP] @ tri`` (f32 accumulation), j = 0, 1, 2.
Every kind adds ``sum(scr[0:8, 0:128])``; out[t] is that total in f32.

* ``sweep_dots(x, tri, kind)`` -> (out (T, 1, 1) f32, swept (T, R, C) bf16):
  on CUDA tensors one launch of ``lt_sweep_dots`` (csrc/sweep_dots.cu: the
  sweeps in registers, the products on the tensor cores as asynchronous
  wgmma from shared memory, tri^T by the strip^T in m64nNTk16 tiles),
  adding one to ``LAUNCHES["sweep_dots"]``; on CPU tensors
  ``sweep_dots_plain``.  swept is the scratch after the kernel (the raw
  frame for ``dots``), returned so the sweep half can be held exactly.
* ``sweep_dots_plain``: the same sweeps in bf16, the products and sums in
  float64, out rounded once to f32.  Against it the kernel's swept is
  exact, its out exact for ``sweeps`` (every partial sum of bf16 values
  that large is exact in f32) and within ``RTOL`` for ``dots`` and
  ``both`` (f32 accumulation in another order).
"""

from __future__ import annotations

import numpy as np
import torch

from lane_tracker_tpu_torch.kernels.build import load_library
from lane_tracker_tpu_torch.kernels.filter_stage import _call, _one_device

SOURCE = {"sweep_dots": "lane_tracker_tpu_torch/csrc/sweep_dots.cu"}
REPLACES = {"sweep_dots": "scripts/mosaic_probe6.py:35"}
LAUNCHES = {name: 0 for name in REPLACES}

# The probe's sizes: frames, frame, row block, product depth and width,
# sweeps; the products read columns col0..col0+KP.
T = 32
ROWS, COLS = 600, 1280
BLOCK, KP, NP = 368, 1152, 1152
COL0 = 64
SWEEPS = 30
KINDS = {"sweeps": 1, "dots": 2, "both": 3}
RTOL = 1e-4
N_BLOCKS = 3  # row blocks at rows 0, 8, 16
BLOCK_STEP = 8
UNSWEPT = 8
CORNER = (8, 128)
TILE = 16  # the wgmma depth: block, KP and col0 are multiples of it
M_TILE = 64  # wgmma's rows: NP (tri's columns) is a multiple of it
STRIP = 32  # columns of one CTA
MAX_ROWS = 32 * 19  # a warp's 32 lanes hold 19 rows each for the sweeps


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def make_inputs(t: int = T, rows: int = ROWS, cols: int = COLS, kp: int = KP,
                n: int = NP, device="cpu") -> tuple:
    """The probe's inputs: x = ``default_rng(0).random((t, rows, cols))`` as
    f32, then bf16; tri = ``tril(ones((kp, n)), -1)`` in bf16."""
    vals = np.random.default_rng(0).random((t, rows, cols)).astype(np.float32)
    x = torch.from_numpy(vals).to(torch.bfloat16)
    tri = torch.from_numpy(np.tril(np.ones((kp, n), np.float32), -1))
    return x.to(device), tri.to(torch.bfloat16).to(device)


def _validate(x, tri, kind, block, col0, sweeps) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    if (x.dim() != 3 or tri.dim() != 2 or x.dtype != torch.bfloat16
            or tri.dtype != torch.bfloat16):
        raise ValueError(f"expected x (T, R, C) and tri (KP, NP) bf16, got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(tri.shape)} "
                         f"{tri.dtype}")
    _, rows, cols = x.shape
    kp, n = tri.shape
    for name, v, least, tile in (("block", block, TILE, TILE),
                                 ("KP", kp, TILE, TILE),
                                 ("NP", n, M_TILE, M_TILE),
                                 ("col0", col0, 0, TILE)):
        if v % tile or v < least:
            raise ValueError(f"{name} = {v}: not a multiple of {tile} (the "
                             f"tensor-core tile) of at least {least}")
    need = (N_BLOCKS - 1) * BLOCK_STEP + block
    if rows < need or cols < col0 + kp:
        raise ValueError(
            f"the products read rows 0..{need} and columns {col0}.."
            f"{col0 + kp} of a ({rows}, {cols}) frame")
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows: the sweeps hold at most {MAX_ROWS} "
                         f"rows of a column in one warp's registers")
    if sweeps < 0:
        raise ValueError(f"sweeps = {sweeps} < 0")


def sweep_dots_plain(x: torch.Tensor, tri: torch.Tensor, kind: str, *,
                     block: int = BLOCK, col0: int = COL0,
                     sweeps: int = SWEEPS) -> tuple:
    """Plain twin of ``sweep_dots``: (out (T, 1, 1) f32, swept)."""
    _validate(x, tri, kind, block, col0, sweeps)
    scr = x.clone()
    m = x.shape[1] - UNSWEPT
    if KINDS[kind] & 1:
        for i in range(sweeps):
            d = i % 7 + 1
            acc = torch.minimum(scr[:, :m], scr[:, d:d + m])
            scr[:, :m] = (acc.float() + 1.0).to(torch.bfloat16)
    r, c = CORNER
    total = scr[:, :r, :c].double().sum((1, 2))
    if KINDS[kind] & 2:
        kp = tri.shape[0]
        a = torch.stack([scr[:, BLOCK_STEP * j:BLOCK_STEP * j + block,
                             col0:col0 + kp] for j in range(N_BLOCKS)], 1)
        total = total + (a.double() @ tri.double()).sum((1, 2, 3))
    return total.float().view(-1, 1, 1), scr


def sweep_dots(x: torch.Tensor, tri: torch.Tensor, kind: str, *,
               block: int = BLOCK, col0: int = COL0,
               sweeps: int = SWEEPS) -> tuple:
    """Probe 6's kernel on x (T, R, C) and tri (KP, NP), both bf16:
    (out (T, 1, 1) f32, swept (T, R, C) bf16).  block, KP and col0 are
    multiples of 16, NP of 64, R at most 608; the products read rows
    0..16 + block and columns col0..col0 + KP of each frame."""
    _validate(x, tri, kind, block, col0, sweeps)
    device = _one_device(x, tri)
    if device.type == "cpu":
        return sweep_dots_plain(x, tri, kind, block=block, col0=col0,
                                sweeps=sweeps)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not (x.is_contiguous() and tri.is_contiguous()):
        raise ValueError("CUDA kernel inputs must be contiguous")
    if tri.data_ptr() % 16:
        raise ValueError("tri must start 16-byte aligned (the kernel copies "
                         "it in 16-byte pieces)")
    t, rows, cols = x.shape
    out = torch.empty((t, 1, 1), dtype=torch.float32, device=x.device)
    swept = torch.empty_like(x)
    partials = torch.empty((t, -(-cols // STRIP)), dtype=torch.float32,
                           device=x.device)
    count = torch.empty(t, dtype=torch.int32, device=x.device)
    kp, n = tri.shape
    _call(device, load_library().lt_sweep_dots,
          x.data_ptr(), tri.data_ptr(), out.data_ptr(), swept.data_ptr(),
          partials.data_ptr(), count.data_ptr(), t, rows, cols, block, col0,
          kp, n, sweeps, KINDS[kind])
    LAUNCHES["sweep_dots"] += 1
    return out, swept
