"""``correct``: the timed path's outputs against the plain reference.

For each checked chunk or step and each stream in it, the reference
(benchmark/reference/) runs the same frames from the same start state and
gives its outputs and end state.  Four numbers are compared, each over
every checked frame and stream, each with the limit the configuration
file states (``check.limits``):

* ``decisions``: frames whose valid, detected, attempt-1 valid and
  detected, attempt count, search mode or render mode differ, plus
  integer and bool elements of the end state that differ;
* ``curve_px``: the largest gap, in warped px over the warped rows, between
  the two sides' curves: each frame's selected and attempt-1 fits where
  both sides detected, and the end state's fits (last, smoothed, and the
  history where both hold a valid entry) and its sampled graphs;
* ``radius_rel``: the largest gap of the shown curve radius (the frames'
  and the end state's), over the reference's (at least 1 m);
* ``overlay_share``: the share of overlay pixels that differ.

The shown eccentricity is not compared on its own: it comes from the
smoothed curves (``curve_px``) through the truncation of their bottom
points, so it moves in steps of half a pixel's width (0.0073 m), one step
of which rounding-level gaps of the curves can already flip.
"""

from __future__ import annotations

import math

import numpy as np

DECISIONS = ("valid", "detected", "a1_valid", "a1_detected", "n_attempts",
             "search_mode", "render_mode")
NUMBERS = ("decisions", "curve_px", "radius_rel", "overlay_share")
COEFF_STATE = ("last_left", "last_right", "avg_left", "avg_right")
INT_STATE = ("last_detection", "hist_valid", "has_avg", "rn_left", "rn_right",
             "rfirst_left", "rfirst_right", "counter", "success")


def curve_gap(a, b, H: int) -> float:
    """Largest |x_a(y) - x_b(y)| over y = 0..H-1 of (..., 3) coefficient
    arrays (x = c0 y^2 + c1 y + c2), in float64; 0 for no curves."""
    a = np.asarray(a, np.float64).reshape(-1, 3)
    b = np.asarray(b, np.float64).reshape(-1, 3)
    if not len(a):
        return 0.0
    y = np.arange(H, dtype=np.float64)
    d = a - b
    gap = np.abs(d[:, :1] * y * y + d[:, 1:2] * y + d[:, 2:3])
    return float(np.nan_to_num(gap, nan=np.inf).max())


def _max(x) -> float:
    x = np.asarray(x, np.float64)
    return float(np.nan_to_num(x, nan=np.inf).max()) if x.size else 0.0


def compare_stream(prog: dict, ref: dict, prog_end: dict, ref_end: dict,
                   H: int) -> dict:
    """The four numbers for one stream's chunk: ``prog`` and ``ref`` are
    output dicts with a leading T axis, ``*_end`` end-state dicts, or
    ``prog_end`` None where the chunk's end state is not compared."""
    decisions = sum(int(np.count_nonzero(np.asarray(prog[k])
                                         != np.asarray(ref[k])))
                    for k in DECISIONS)
    if prog_end is not None:
        decisions += sum(int(np.count_nonzero(np.asarray(prog_end[k])
                                              != np.asarray(ref_end[k])))
                         for k in INT_STATE)
    both = np.asarray(prog["detected"]) & np.asarray(ref["detected"])
    both1 = np.asarray(prog["a1_detected"]) & np.asarray(ref["a1_detected"])
    gaps = [curve_gap(prog[f"{s}_coeffs"][both], ref[f"{s}_coeffs"][both], H)
            for s in ("left", "right")]
    gaps += [curve_gap(prog[f"a1_{s}_coeffs"][both1],
                       ref[f"a1_{s}_coeffs"][both1], H)
             for s in ("left", "right")]
    radius_p, radius_r = [np.ravel(prog["radius"])], [np.ravel(ref["radius"])]
    if prog_end is not None:
        gaps += [curve_gap(prog_end[k], ref_end[k], H) for k in COEFF_STATE]
        hv = (np.asarray(prog_end["hist_valid"])
              & np.asarray(ref_end["hist_valid"]))
        gaps += [curve_gap(np.asarray(prog_end[k])[hv],
                           np.asarray(ref_end[k])[hv], H)
                 for k in ("hist_left", "hist_right")]
        gaps += [_max(np.abs(np.asarray(prog_end[k], np.float64)
                             - np.asarray(ref_end[k], np.float64)))
                 for k in ("rfitx_left", "rfitx_right")]
        radius_p += [np.ravel(prog_end[k]) for k in ("avg_radius", "radii")]
        radius_r += [np.ravel(ref_end[k]) for k in ("avg_radius", "radii")]
    radius_p = np.concatenate(radius_p).astype(np.float64)
    radius_r = np.concatenate(radius_r).astype(np.float64)
    radius_rel = _max(np.abs(radius_p - radius_r)
                      / np.maximum(np.abs(radius_r), 1.0))
    if "overlay" in prog:
        differ = np.any(np.asarray(prog["overlay"])
                        != np.asarray(ref["overlay"]), axis=-1)
        overlay = (int(np.count_nonzero(differ)), int(differ.size))
    else:
        overlay = (0, 0)
    return {"decisions": decisions, "curve_px": max(gaps),
            "radius_rel": radius_rel, "overlay": overlay}


def combine(parts: list[dict]) -> dict:
    """The numbers over several streams and chunks: decisions summed,
    gaps at their largest, the overlay's differing pixels over all."""
    pix = sum(p["overlay"][0] for p in parts)
    tot = sum(p["overlay"][1] for p in parts)
    return {"decisions": sum(p["decisions"] for p in parts),
            "curve_px": max(p["curve_px"] for p in parts),
            "radius_rel": max(p["radius_rel"] for p in parts),
            "overlay_share": pix / tot if tot else 0.0}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or under its limit (a NaN never is)."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(not math.isnan(float(v["value"]))
             and float(v["value"]) <= float(v["limit"])
             for v in table.values())
    return ok, table
