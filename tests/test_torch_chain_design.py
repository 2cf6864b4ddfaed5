"""The redesigned shift chains' plans and models against the plain twin.

``tests/torch_filter_models.py`` models ``lt_shift_chain``'s line kernel
(``chain_orbits``: which line position each lane's register holds, where
the lanes' runs and the orbits end, what each slot reads; ``chain_model``:
the passes as shifts by one slot, a shuffle at each lane's end, the fill or
the cycle's first slot at each orbit's end, or plain order for the
packed-u16 body, short-orbit slices and lines whose orbits need more than
a warp's lanes) and
``lt_shift_chain_2d``'s tiles (``chain2d_tiles``, ``chain2d_model``: m
outer steps a launch over each tile's region, its halo wrapping modulo the
block).  Here, on the CPU:

* every runnable variant's model equals ``shift_chain_plain`` at 40 x 256,
  K = 8, and on ragged blocks (37 x 45, 300 x 131, 5 x 1500) at K = 12;
* rolls and slices at and past a line's length (45, 46, 101 on W = 45),
  and rolls whose gcd with the line is above 1;
* lines at the kernels' length limit, 8192, along each axis (plain order
  across warps);
* each orbit plan covers every position of a line exactly once, reads
  only positions of the line or the fill, and reads each position from
  exactly one slot;
* the 2-D plan's tiles cover each output once, and the 2-D model is exact
  at m = 1, 4 and 16 steps a launch, also where the halo (9 m) reaches H
  or W.

Tolerance: exact (integer bodies wrap alike; bf16 rounds after every op in
both).  The kernels themselves are held to the twin, and the library's
plans (``shift_chain.chain_plan``) to these models, on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_filter_models import (
    CHAIN_REGS,
    chain2d_model,
    chain2d_tiles,
    chain_mode,
    chain_model,
    chain_orbits,
)

from lane_tracker_tpu_torch.kernels import shift_chain as sc

CHAINS = [v.name for v in sc.VARIANTS
          if not v.rejected and v.body != "morph_chain8"]
RAGGED = [(37, 45), (300, 131), (5, 1500)]
MORPH = sc.BY_NAME["bf16_morph_chain8"]


def _input(v, shape, seed):
    vals = np.random.default_rng(seed).integers(0, v.high, shape)
    return torch.from_numpy(vals).to(sc.DTYPES[v.dtype])


def _same(got, want, what):
    n = int((got.double() != want.double()).sum())
    assert n == 0, f"{what}: {n} of {want.numel()} values differ"


@pytest.mark.parametrize("name", CHAINS)
def test_chain_model_equals_twin(name):
    v = sc.BY_NAME[name]
    x = _input(v, (40, 256), 0)
    _same(chain_model(x, v, 8), sc.shift_chain_plain(x, v, 8), name)


@pytest.mark.parametrize("name", CHAINS)
def test_chain_model_equals_twin_on_ragged_blocks(name):
    v = sc.BY_NAME[name]
    for i, shape in enumerate(RAGGED):
        x = _input(v, shape, i)
        _same(chain_model(x, v, 12), sc.shift_chain_plain(x, v, 12),
              f"{name} {shape}")


@pytest.mark.parametrize("name", ["i32_lane_roll_add_s17",
                                  "u8_sublane_roll_min_s17",
                                  "bf16_roll_sub_minmax",
                                  "i32_packed_u16_shift_add_s17",
                                  "int16_lane_slice_min_s17",
                                  "bf16_sub_max_s3"])
@pytest.mark.parametrize("shift", [45, 46, 101, 15, 9])
def test_chain_model_at_and_past_a_line(name, shift):
    """Shifts of a line's length and more (a roll wraps, a slice reads only
    the fill), and rolls by 15 and 9, whose gcd with 45 is 15 and 9."""
    v = sc.BY_NAME[name]
    shifts = (shift, shift + 1) if v.body == "packed" else (shift,)
    w = dataclasses.replace(v, shifts=shifts, margin=shift)
    x = _input(w, (37, 45) if w.axis == 1 else (45, 37), shift)
    _same(chain_model(x, w, 8), sc.shift_chain_plain(x, w, 8),
          f"{name} by {shift}")


# One variant a (type, boundary, axis) kind that a long line reaches, as
# tests/test_torch_cuda.py's length-limit cases.
LONG = ["i32_lane_roll_add_s17", "i32_sublane_roll_add_s17",
        "uint8_lane_slice_min_s17", "uint8_sub_slice_min_s17",
        "i16_sublane_roll_add_s17", "bf16_sub_min_s17",
        "bf16_roll_sub_minmax", "i32_packed_u16_shift_add_s17",
        "f32_lane_roll_min_s17", "i32_lane_roll_add_s128_fine"]


@pytest.mark.parametrize("name", LONG)
def test_chain_model_at_the_length_limit(name):
    """Lines of 8192 elements, the kernels' limit: their orbits need more
    than one warp's lanes, so they take the plain order across warps."""
    v = sc.BY_NAME[name]
    shape = (3, 8192) if v.axis == 1 else (8192, 3)
    x = _input(v, shape, 1)
    assert chain_mode(v, 8192, v.n_passes(8)) == "plain"
    _same(chain_model(x, v, 8), sc.shift_chain_plain(x, v, 8), name)


PLANS = [(1280, 17, "circular"), (1280, 128, "circular"),
         (1104, 8, "circular"), (1104, 3, "circular"), (1104, 17, "fill"),
         (1280, 1, "fill"), (45, 0, "circular"), (45, 0, "fill"),
         (45, 45, "fill"), (45, 101, "fill"), (45, 15, "circular"),
         (1500, 17, "fill"), (8192, 17, "circular"), (8192, 4096, "circular"),
         (8192, 3, "fill"), (1, 0, "circular"), (7, 3, "fill")]


@pytest.mark.parametrize("passes", [None, 8, 64])
@pytest.mark.parametrize("L,s,boundary", PLANS)
def test_orbit_plan_covers_the_line_once(L, s, boundary, passes):
    """Without ``passes`` (or with more than a cycle's padding) the plan
    with its ends; with them, where a roll's padding allows, the periodic
    plan: its real slots cover the line once and its padding repeats each
    cycle."""
    p = chain_orbits(L, s, boundary, passes)
    pos, reads = p["pos"], p["reads"]
    valid = p["real"]
    assert sorted(pos[valid].tolist()) == list(range(L))
    if p["periodic"]:
        assert not p["end"].any()
        assert (pos >= 0).all()
        # every slot reads the element after its own on the cycle, but a
        # cycle's last lane's last register (its shuffle of the first)
        nxt = np.concatenate([pos[:, 1:], pos[p["src"], :1]], axis=1)
        want = (pos - s) % L
        ok = nxt == want
        last = np.zeros_like(ok)
        last[p["src"] <= np.arange(p["lanes"]), -1] = True
        assert (ok | last).all()
        return
    assert (pos[~valid] == -1).all()
    # each slot reads what the shift says: a roll p - s, a slice p + s or
    # the fill (L)
    want = (pos - s) % L if boundary == "circular" else np.where(
        pos + s < L, pos + s, L)
    np.testing.assert_array_equal(reads[valid], want[valid])
    # a roll's cycle starts at register 0 of a lane, so its end's wrap is
    # one shuffle of register 0; a run's neighbour is the next register
    if p["roll"]:
        starts = valid & (np.arange(CHAIN_REGS) == 0)
        assert int(starts.sum()) >= L // (L // np.gcd(s, L))
    assert p["lanes"] == pos.shape[0]


def test_the_probes_lines_fit_a_warp_or_take_the_plain_order():
    """At the probes' block (1104, 1280) every roll and slice but three
    holds its lines in orbit order in one warp's registers (no barrier in
    its pass loop); the packed-u16 body and the roll by 128 (128 cycles of
    10, which would leave three quarters of the slots padding) keep plain
    order, one warp a line."""
    spans = {}
    for v in sc.VARIANTS:
        if v.rejected or v.boundary is None or v.body == "morph_chain8":
            continue
        L = sc.W if v.axis == 1 else sc.H
        mode = chain_mode(v, L, v.n_passes())
        s = v.shifts[0] % L if v.boundary == "circular" else v.shifts[0]
        lanes = (chain_orbits(L, s, v.boundary, v.n_passes())["lanes"]
                 if mode == "orbit" else -(-L // CHAIN_REGS))
        assert lanes <= 32, v.name
        if mode == "plain":
            spans[v.name] = lanes
    assert spans == {"i32_packed_u16_shift_add_s17": 32,
                     "i32_packed_oddshift_add": 32,
                     "i32_lane_roll_add_s128_fine": 32}


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("shape", [(1104, 1280), (37, 45), (300, 131),
                                   (5, 1500), (9, 200)])
def test_chain2d_tiles_cover_each_output_once(shape, m):
    H, W = shape
    plan = chain2d_tiles(H, W, m, 3, 6 % W, 3 % H, 6 % H)
    seen = np.zeros(shape, np.int64)
    for r0, c0 in plan["tiles"]:
        seen[r0:r0 + plan["th"], c0:c0 + plan["tw"]] += 1
    assert (seen == 1).all()
    assert plan["smem"] <= 227 * 1024


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("shape", [(40, 256), (37, 45), (12, 20), (5, 9)])
def test_chain2d_model_equals_twin(shape, m):
    """m steps a launch over 4 outer steps (K = 16) and 5 (K = 20, a last
    launch of fewer steps); the small blocks are narrower than the halo of
    9 m, so the regions wrap around them."""
    rng = np.random.default_rng(m)
    x = _input(MORPH, shape, m)
    for k in (16, 20):
        want = sc.shift_chain_plain(x, MORPH, k)
        got = chain2d_model(x, MORPH.n_passes(k), m, MORPH.shifts, rng)
        _same(got, want, f"{shape} m={m} K={k}")
