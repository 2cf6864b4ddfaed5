"""The morphology probes' shift chains: wrapper, plain twin, variant table.

Port of the Pallas kernels of scripts/mosaic_probe.py, mosaic_probe2.py,
mosaic_probe3.py and mosaic_probe4.py.  Each probe times K chained passes
``x = body(x, shift(x))`` over one (1104, 1280) block to learn what the
filter's morphology primitive costs in each dtype and shift form.  Every
row those probes print is one ``Variant`` of ``VARIANTS`` under the same
name (65 rows: 64 that run, and ``i16_sublane_slice_add_s17``, whose slice
reads past its scratch and is rejected, as the reference rejects it).  The
table is this package's own copy; it never reads the scripts.

* ``shift_chain``    <- ``run_variant`` (mosaic_probe.py:32), ``run`` and
  ``slice_op`` (mosaic_probe2.py:31, :143), ``pingpong`` and ``plain``
  (mosaic_probe3.py:37, :120), ``pingpong`` (mosaic_probe4.py:36).  On CUDA
  tensors it calls ``lt_shift_chain`` (csrc/shift_chain.cu; one kernel
  launch), or for ``bf16_morph_chain8`` ``lt_shift_chain_2d`` (a few
  kernel launches, ``chain_plan``'s ``launches``); on CPU tensors it runs
  ``shift_chain_plain``.  Every call adds one to ``LAUNCHES["shift_chain"]``
  or ``LAUNCHES["shift_chain_2d"]``; the twin never counts.  The library's
  own count of kernel launches (``filter_stage.kernel_launches``) counts
  each kernel.

``chain_plan`` reads the launchers' plan of a call from the library
(``lt_shift_chain_plan``): how a line's slots spread over lanes and warps,
or the 2-D chain's launches and tiles.

Shifts: a roll (``"circular"``) is ``torch.roll``: the element at p reads
p - s, mod the line's length.  A slice (``"fill"``) reads p + s of a
scratch whose margin holds ``fill`` (0 in the slice variants; in the
ping-pong variants 255 for min, else 0).  Arithmetic is the dtype's, op by
op: integers wrap, bf16 rounds after every op, and constants are cast to
the dtype first (``bfloat16(0.999)`` is 1.0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lane_tracker_tpu_torch.kernels.build import load_library
from lane_tracker_tpu_torch.kernels.filter_stage import _call, _check

SOURCE = {"shift_chain": "lane_tracker_tpu_torch/csrc/shift_chain.cu",
          "shift_chain_2d": "lane_tracker_tpu_torch/csrc/shift_chain.cu"}
REPLACES = {"shift_chain": "scripts/mosaic_probe.py:32",
            "shift_chain_2d": "scripts/mosaic_probe2.py:31"}
LAUNCHES = {name: 0 for name in REPLACES}

# The probes' block and chain length.
H, W = 1104, 1280
K = 64

DTYPES = {"uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
          "int32": torch.int32, "bfloat16": torch.bfloat16,
          "float32": torch.float32}
# Codes of csrc/shift_chain.cu.
_DTYPE_CODE = {"uint8": 0, "int8": 1, "int16": 2, "int32": 3, "bfloat16": 4,
               "float32": 5}
_BODY_CODE = {"add": 0, "min": 1, "max": 2, "add_self": 3, "minadd": 4,
              "addshift": 5, "where_add": 6, "packed": 7, "min_mul_max": 8,
              "morph_chain8": 9}
_BOUND_CODE = {None: 0, "circular": 1, "fill": 2}
# Operations per element of one pass of each body (for the bound).
BODY_OPS = {"add": 1, "min": 1, "max": 1, "add_self": 1, "minadd": 2,
            "addshift": 3, "where_add": 3, "packed": 5, "min_mul_max": 3,
            "morph_chain8": 5}
_PASSES = {"K": 1, "K//2": 2, "K//4": 4}  # K over the divisor
# lt_shift_chain_plan's fields, and its line modes.
_LINE_PLAN = ("mode", "lanes", "warps", "lines_a_cta", "ctas", "smem",
              "regs")
_PLAN_2D = ("launches", "th", "tw", "rh", "rww", "col0", "tiles", "smem",
            "fast", "run_w", "run_h")
_MODES = ("orbit", "plain", "plain_warp")
_INT_BITS = {"uint8": (8, False), "int8": (8, True), "int16": (16, True),
             "int32": (32, True)}


@dataclasses.dataclass(frozen=True)
class Variant:
    """One row of probes 1-4.

    ``shifts``: the body's shift(s) along ``axis`` (1 lanes, 0 sublanes;
    ``bf16_morph_chain8`` rolls along both, by ``shifts`` each).
    ``margin``: a slice's scratch margin along ``axis`` past the block;
    a shift longer than it reads outside the scratch.  ``shape``: None for
    the probe's (H, W).  ``high``: inputs are ``default_rng(0).integers(0,
    high, shape)`` cast to ``dtype`` (``init`` says how the probe casts:
    through int32 or float32, which gives the same values).
    """

    name: str
    probe: int
    dtype: str
    body: str
    boundary: str | None = None
    axis: int | None = None
    shifts: tuple = ()
    fill: int = 0
    consts: tuple = ()
    passes: str = "K"
    shape: tuple | None = None
    init: str = "int"
    high: int = 100
    margin: int | None = None

    def n_passes(self, k: int = K) -> int:
        return k // _PASSES[self.passes]

    def check(self) -> None:
        """Raise ValueError for a variant the reference cannot run."""
        if self.boundary == "fill" and self.shifts[0] > self.margin:
            what = "rows" if self.axis == 0 else "columns"
            raise ValueError(
                f"{self.name}: the slice reads {what} {self.shifts[0]}.."
                f"{self.shifts[0]} + n of a scratch with n + {self.margin}")

    @property
    def rejected(self) -> bool:
        try:
            self.check()
        except ValueError:
            return True
        return False


def _roll(name, probe, dtype, body, axis, shift, **kw):
    return Variant(name, probe, dtype, body, boundary="circular", axis=axis,
                   shifts=(shift,), **kw)


def _slice(name, probe, dtype, body, axis, shift, margin, fill=0, **kw):
    return Variant(name, probe, dtype, body, boundary="fill", axis=axis,
                   shifts=(shift,), fill=fill, margin=margin, **kw)


def _probe1():
    # scratch (H + 8, W + 128) for the slices
    m = {0: 8, 1: 128}
    rows = [
        _roll("i32_lane_roll_add_s1", 1, "int32", "add", 1, 1),
        _roll("i32_lane_roll_add_s17", 1, "int32", "add", 1, 17),
        _roll("i32_sublane_roll_add_s1", 1, "int32", "add", 0, 1),
        _roll("i32_sublane_roll_add_s17", 1, "int32", "add", 0, 17),
        _roll("i16_lane_roll_add_s1", 1, "int16", "add", 1, 1),
        _roll("i16_lane_roll_add_s17", 1, "int16", "add", 1, 17),
        _roll("i16_sublane_roll_add_s17", 1, "int16", "add", 0, 17),
        _roll("i16_lane_roll_min_s17", 1, "int16", "min", 1, 17),
        _roll("u8_lane_roll_min_s17", 1, "uint8", "min", 1, 17),
        _roll("i8_lane_roll_min_s17", 1, "int8", "min", 1, 17),
        _roll("u8_sublane_roll_min_s17", 1, "uint8", "min", 0, 17),
        Variant("i32_add_only", 1, "int32", "add_self"),
        Variant("i16_add_only", 1, "int16", "add_self"),
        Variant("u8_minadd_only", 1, "uint8", "minadd", consts=(1,)),
        Variant("i16_minadd_only", 1, "int16", "minadd", consts=(1,)),
        _slice("i16_lane_slice_add_s17", 1, "int16", "add", 1, 17, m[1]),
        _slice("i16_sublane_slice_add_s17", 1, "int16", "add", 0, 17, m[0]),
        _slice("i32_lane_slice_add_s17", 1, "int32", "add", 1, 17, m[1]),
        Variant("i32_packed_u16_shift_add_s17", 1, "int32", "packed",
                boundary="circular", axis=1, shifts=(8, 9)),
    ]
    return rows


def _probe2():
    f = {"init": "f"}
    rows = [
        _roll("bf16_lane_roll_min_s17", 2, "bfloat16", "min", 1, 17, **f),
        _roll("bf16_sublane_roll_min_s17", 2, "bfloat16", "min", 0, 17, **f),
        _roll("bf16_lane_roll_min_s1", 2, "bfloat16", "min", 1, 1, **f),
        _roll("bf16_lane_roll_max_s17", 2, "bfloat16", "max", 1, 17, **f),
        Variant("i16_min_plain", 2, "int16", "minadd", consts=(1,)),
        Variant("u8_min_plain_1088", 2, "uint8", "minadd", consts=(1,),
                shape=(1088, 1280)),
        Variant("i16_where_add", 2, "int16", "where_add", consts=(3, 3)),
        _roll("i32_lane_roll_add_s17_fine", 2, "int32", "add", 1, 17),
        _roll("i32_lane_roll_add_s128_fine", 2, "int32", "add", 1, 128),
        _roll("i32_sublane_roll_add_s8_fine", 2, "int32", "add", 0, 8),
        Variant("i32_addshift_only_fine", 2, "int32", "addshift", consts=(1,)),
        _roll("f32_lane_roll_min_s17", 2, "float32", "min", 1, 17, **f),
        _roll("f32_sublane_roll_min_s17", 2, "float32", "min", 0, 17, **f),
        Variant("i32_packed_oddshift_add", 2, "int32", "packed",
                boundary="circular", axis=1, shifts=(8, 9), passes="K//2"),
    ]
    # slice_op: scratch (H + 32, W + 128), zero margins, named by numpy's
    # dtype name
    for op, dtype, axis, init in (
            ("min", "uint8", 1, "int"), ("min", "uint8", 0, "int"),
            ("add", "uint8", 1, "int"), ("min", "bfloat16", 1, "f"),
            ("min", "bfloat16", 0, "f"), ("min", "int16", 1, "int"),
            ("min", "int16", 0, "int"), ("add", "int16", 0, "int"),
            ("min", "float32", 1, "f")):
        name = f"{dtype}_{'sub' if axis == 0 else 'lane'}_slice_{op}_s17"
        rows.append(_slice(name, 2, dtype, op, axis, 17,
                           32 if axis == 0 else 128, init=init))
    rows.append(Variant("bf16_morph_chain8", 2, "bfloat16", "morph_chain8",
                   boundary="circular", shifts=(3, 6), passes="K//4",
                   init="f"))
    return rows


def _pingpong(name, probe, dtype, op, axis, shift, high):
    # two (H + 128, W + 256) scratches: margins MY = 64, MX = 128, filled
    # with 255 for min and 0 otherwise
    return _slice(name, probe, dtype, op, axis, shift,
                  64 if axis == 0 else 128, fill=255 if op == "min" else 0,
                  init="int" if dtype == "int32" else "f", high=high)


def _probe3():
    rows = [_pingpong(n, 3, dt, op, ax, s, 100) for n, dt, op, ax, s in (
        ("i32_pp_lane_min_s17", "int32", "min", 1, 17),
        ("i32_pp_sub_min_s17", "int32", "min", 0, 17),
        ("i32_pp_lane_add_s17", "int32", "add", 1, 17),
        ("i32_pp_sub_add_s17", "int32", "add", 0, 17),
        ("i32_pp_lane_min_s1", "int32", "min", 1, 1),
        ("f32_pp_lane_min_s17", "float32", "min", 1, 17),
        ("f32_pp_sub_min_s17", "float32", "min", 0, 17),
        ("bf16_pp_lane_min_s17", "bfloat16", "min", 1, 17),
        ("bf16_pp_sub_min_s17", "bfloat16", "min", 0, 17),
        ("bf16_pp_lane_max_s3", "bfloat16", "max", 1, 3),
        ("bf16_pp_lane_add_s17", "bfloat16", "add", 1, 17))]
    f = {"init": "f"}
    rows += [
        Variant("retry_i16_min", 3, "int16", "minadd", consts=(1,)),
        _roll("retry_bf16_roll_min", 3, "bfloat16", "min", 1, 17, **f),
        Variant("retry_i16_cmp_select", 3, "int16", "where_add",
                consts=(3, 3)),
        Variant("bf16_cmp_select", 3, "bfloat16", "where_add",
                consts=(3.0, 1.0), **f),
        Variant("bf16_roll_sub_minmax", 3, "bfloat16", "min_mul_max",
                boundary="circular", axis=0, shifts=(3,), consts=(0.999,),
                **f),
    ]
    return rows


def _probe4():
    return [_pingpong(n, 4, dt, op, ax, s, 256) for n, dt, op, ax, s in (
        ("bf16_sub_min_s3", "bfloat16", "min", 0, 3),
        ("bf16_sub_min_s17", "bfloat16", "min", 0, 17),
        ("bf16_sub_max_s3", "bfloat16", "max", 0, 3),
        ("bf16_lane_min_s17", "bfloat16", "min", 1, 17),
        ("i32_sub_min_s3", "int32", "min", 0, 3),
        ("i32_sub_min_s17", "int32", "min", 0, 17))]


VARIANTS = (*_probe1(), *_probe2(), *_probe3(), *_probe4())
BY_NAME = {v.name: v for v in VARIANTS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def make_input(v: Variant, h: int = H, w: int = W,
               device="cpu") -> torch.Tensor:
    """The probe's input when its block is (h, w):
    ``default_rng(0).integers(0, high, shape)`` as the variant's dtype."""
    shape = v.shape if v.shape is not None else (h, w)
    vals = np.random.default_rng(0).integers(0, v.high, shape)
    return torch.from_numpy(vals).to(DTYPES[v.dtype]).to(device)


# ---- plain twin ------------------------------------------------------------


def _wrap(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """Integer values (held in int64) wrapped to the dtype's range."""
    if dtype not in _INT_BITS:
        return x
    bits, signed = _INT_BITS[dtype]
    mask = (1 << bits) - 1
    if not signed:
        return x & mask
    half = 1 << (bits - 1)
    return ((x + half) & mask) - half


def _const(c, x: torch.Tensor, v: Variant):
    """A body constant in the dtype: rounded to bf16 / f32 first."""
    if v.dtype in _INT_BITS:
        return int(c)
    return torch.tensor(c, dtype=DTYPES[v.dtype], device=x.device)


def _shifted(x: torch.Tensor, v: Variant, s: int, axis: int) -> torch.Tensor:
    if v.boundary == "circular":
        return torch.roll(x, s, axis)
    n = x.shape[axis]
    s = min(s, n)
    pad_shape = list(x.shape)
    pad_shape[axis] = s
    return torch.cat([x.narrow(axis, s, n - s), x.new_full(pad_shape, v.fill)],
                     axis)


def _pass(x: torch.Tensor, v: Variant) -> torch.Tensor:
    wrap = lambda t: _wrap(t, v.dtype)  # noqa: E731
    sh = lambda s: _shifted(x, v, s, v.axis)  # noqa: E731
    b = v.body
    if b == "add":
        return wrap(x + sh(v.shifts[0]))
    if b == "min":
        return torch.minimum(x, sh(v.shifts[0]))
    if b == "max":
        return torch.maximum(x, sh(v.shifts[0]))
    if b == "add_self":
        return wrap(x + x)
    if b == "minadd":
        return torch.minimum(wrap(x + _const(v.consts[0], x, v)), x)
    if b == "addshift":
        return wrap(wrap(x + (x >> 1)) + v.consts[0])
    if b == "where_add":
        c, d = (_const(c, x, v) for c in v.consts)
        return torch.where(x > c, x, wrap(x + d))
    if b == "packed":
        r8, r9 = sh(v.shifts[0]), sh(v.shifts[1])
        odd = (x >> 16) | wrap(r9 << 16)
        return wrap(wrap(x + odd) + r8)
    if b == "min_mul_max":
        return torch.maximum(torch.minimum(x, sh(v.shifts[0])),
                             x * _const(v.consts[0], x, v))
    if b == "morph_chain8":
        a1, a2 = v.shifts
        e = torch.minimum(x, torch.roll(x, a1, 1))
        e = torch.minimum(e, torch.roll(e, a2, 1))
        d = torch.maximum(e, torch.roll(e, a1, 0))
        return x - torch.maximum(d, torch.roll(d, a2, 0))
    raise ValueError(f"unknown body {b!r}")


def _validate(x: torch.Tensor, v: Variant | str) -> Variant:
    v = BY_NAME[v] if isinstance(v, str) else v
    v.check()
    if x.dim() != 2 or x.dtype != DTYPES[v.dtype]:
        raise ValueError(f"{v.name}: expected an (H, W) {v.dtype} tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    return v


def shift_chain_plain(x: torch.Tensor, v: Variant | str,
                      k: int = K) -> torch.Tensor:
    """Plain twin of ``shift_chain``."""
    v = _validate(x, v)
    y = x.long() if v.dtype in _INT_BITS else x
    for _ in range(v.n_passes(k)):
        y = _pass(y, v)
    return y.to(x.dtype)


def _args(v: Variant, h: int, w: int) -> tuple:
    """(axis, s1, s2) as the C entries take them: a roll's shifts reduced
    to [0, L) along its line; for the 2-D chain (axis None) the lane
    shifts mod w and the row shifts mod h."""
    if v.body == "morph_chain8":
        a1, a2 = v.shifts
        return None, (a1 % w, a2 % w, a1 % h, a2 % h)
    length = w if v.axis in (1, None) else h
    s1, s2 = ((*v.shifts, 0)[:2] if v.shifts else (0, 0))
    if v.boundary == "circular":
        s1, s2 = s1 % length, s2 % length
    return 1 if v.axis is None else v.axis, (s1, s2)


def chain_plan(v: Variant | str, h: int = H, w: int = W, k: int = K) -> dict:
    """The plan the launcher makes on this card for the variant's chain on
    an (h, w) block (``lt_shift_chain_plan``).  A single-axis shift chain:
    {mode ("orbit", "plain" or "plain_warp"), lanes and warps a line, packed
    lines a CTA, CTAs, smem (a CTA's shared bytes), regs (slots a lane)}.
    ``bf16_morph_chain8``: {launches a call, and the first launch's th, tw
    (tile), rh, rww (region rows, 32-bit words a row), col0, tiles, smem,
    fast (chain2d_fast_kernel), run_w, run_h (its register runs)}."""
    v = BY_NAME[v] if isinstance(v, str) else v
    if v.boundary is None:
        raise ValueError(f"{v.name}: an elementwise body has no line plan")
    axis, shifts = _args(v, h, w)
    s = (*shifts, 0, 0)[:4]
    out = np.zeros(11, np.int32)
    elem = torch.tensor([], dtype=DTYPES[v.dtype]).element_size()
    _check(load_library().lt_shift_chain_plan(
        h, w, elem, _BODY_CODE[v.body], _BOUND_CODE[v.boundary],
        1 if axis is None else axis, *s, v.n_passes(k), out.ctypes.data),
        "lt_shift_chain_plan")
    if v.body == "morph_chain8":
        return dict(zip(_PLAN_2D, map(int, out)))
    plan = dict(zip(_LINE_PLAN, map(int, out)))
    plan["mode"] = _MODES[plan["mode"]]
    return plan


def shift_chain(x: torch.Tensor, v: Variant | str, k: int = K) -> torch.Tensor:
    """The variant's chain of passes over the (H, W) block x (k = the
    probe's K; the variant runs K, K // 2 or K // 4 passes)."""
    v = _validate(x, v)
    if x.device.type == "cpu":
        return shift_chain_plain(x, v, k)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("CUDA kernel inputs must be contiguous")
    h, w = x.shape
    out = torch.empty_like(x)
    lib = load_library()
    axis, shifts = _args(v, h, w)
    if v.body == "morph_chain8":
        # the scratch between launches; q and bar are unused
        p = torch.empty_like(x)
        _call(x.device, lib.lt_shift_chain_2d,
              x.data_ptr(), out.data_ptr(), p.data_ptr(), None, None, h, w,
              v.n_passes(k), *shifts)
        LAUNCHES["shift_chain_2d"] += 1
        return out
    c1, c2 = (*map(float, v.consts), 0.0, 0.0)[:2]
    _call(x.device, lib.lt_shift_chain,
          x.data_ptr(), out.data_ptr(), h, w, _DTYPE_CODE[v.dtype],
          _BODY_CODE[v.body], _BOUND_CODE[v.boundary], axis, *shifts,
          v.n_passes(k), float(v.fill), c1, c2)
    LAUNCHES["shift_chain"] += 1
    return out
