"""The redesigned in-tile gather's model against the plain twin.

``tests/torch_filter_models.tile_gather_model`` walks ``lt_tile_gather``'s
layouts (csrc/tile_gather.cu) as index arithmetic: the low 7 bits of
``s + prev`` a byte, four bytes a 32-bit word; B0 and G2 a thread a
column, G2 one ``__byte_perm`` of the column's two words; G1 a warp a row,
each lane's four columns' gathers four ``__shfl_sync`` and three
``__byte_perm``; G3 eight such warps a tile, their rows written to a
shared copy and G2 one byte of it an element, after one barrier.
Here, on the CPU, the model equals ``tile_gather_plain`` bit for bit for
every op at reps 0, 1, 16 and 64, on (8, 128), the probe's (128, 1280)
and (40, 384); with li and si carrying bits above the tile (read modulo
it), and with src near the int32 limits (the add wraps).  ``byte_perm``
is pinned on its own, and G3's reads of the shared copy to one bank a
lane.

Tolerance: exact (integer).  The kernel itself is held to the twin on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from tests.torch_filter_models import (
    GATHER_REPS,
    GATHER_SHAPES,
    byte_perm,
    g3_copy_at,
    gather_inputs,
    tile_gather_model,
)

from lane_tracker_tpu_torch.kernels import tile_gather as tg


@pytest.mark.parametrize("wide", [False, True], ids=["probe", "wide"])
@pytest.mark.parametrize("shape", GATHER_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op", list(tg.OPS))
def test_gather_model_equals_twin(op, shape, wide):
    seed = 8 * list(tg.OPS).index(op) + 2 * GATHER_SHAPES.index(shape) + wide
    src, li, si = gather_inputs(shape, seed, wide)
    t = [torch.from_numpy(a) for a in (src, li, si)]
    for reps in GATHER_REPS:
        want = tg.tile_gather_plain(*t, op, reps).numpy()
        got = tile_gather_model(src, li, si, op, reps)
        np.testing.assert_array_equal(got, want, err_msg=f"reps={reps}")


def test_byte_perm_selects_bytes():
    x = np.array([0x03020100], np.uint32)
    y = np.array([0x07060504], np.uint32)
    for s in (0x3210, 0x7654, 0x5140, 0x7362, 0x5410, 0x7632, 0x0000, 0x4567):
        want = sum(((s >> (4 * n)) & 7) << (8 * n) for n in range(4))
        assert int(byte_perm(x, y, s)[0]) == want, hex(s)


def test_g3_copy_reads_are_bank_conflict_free():
    """The model's G3 reads (``g3_copy_at``): lane l's column l + 32 j of
    row si & 7 is byte j of word 32 (si & 7) + l, so bank l whatever si."""
    rng = np.random.default_rng(7)
    lane = np.arange(32)
    for _ in range(8):
        si = rng.integers(-2 ** 31, 2 ** 31, (4, 32))
        at = g3_copy_at(si)
        assert ((at // 4) % 32 == lane).all()
        assert (at // 4 // 32 == si & 7).all()
        assert (at % 4 == np.arange(4)[:, None]).all()
