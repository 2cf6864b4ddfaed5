"""The port's 'turbo' pipeline against the JAX package's, on the CPU.

'turbo' (lane_tracker_tpu/tracker/step.py:433-455) takes LAB-B on the
undistorted band and warps (R, LAB-B) as one pair with the fill bias
128 * (1 - sum of the warp weights) on LAB-B.  Held at full size (the
helpers and tolerances of tests/torch_modes.py):

* the fill bias's add: the port's ``combine_taps(..., bias)`` equals JAX's
  under jit at every pixel of the ROI warp grid (taps gathered from random
  sources) and at its tiny-weight pixels on taps nearest a rint tie; the
  pair gather with ``bias_b`` against JAX's: channel a bit-exact, channel
  b within the warp contract, because XLA contracts the pair's second
  output in another order (fma(p11, w11, fma(p10, w10, fma(p01, w01,
  p00 * w00)))) than the single gather the port's one order follows;
* ``warp_channels`` on the stills and a black frame: R bit-exact, LAB-B
  within the warp contract, 128 where the warp reads no source pixel;
* ``chunk_process`` at T=8 from a fresh state (two_phase, a black frame);
* ``LaneTracker.process`` over tests/test_torch_tracker.py's schedule: the
  decisions, the diagnostics transcript line for line, the search pictures
  exactly, snapshots continued across the packages both ways;
* a two-stream fleet equals the chunk on each stream;
* ``python -m lane_tracker_tpu_torch --pipeline turbo`` (in process, on
  the CPU) logs JAX's CLI's frames line for line.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax

from tests import torch_modes as tm
from tests.conftest import ASSETS_DIR
from tests.test_torch_fma import _near_ties

from lane_tracker_tpu.kernels import resample as j_resample
from lane_tracker_tpu.process_video import run as j_run

from lane_tracker_tpu_torch import process_video as t_cli
from lane_tracker_tpu_torch.kernels import resample as t_resample

PIPELINE = "turbo"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return tm.build_both(PIPELINE)


def _random_taps(g, rng):
    """The four taps of every pixel of grid ``g`` from a random source."""
    Ws, Hs = g.src_size
    src = rng.integers(0, 256, Hs * Ws, dtype=np.uint8)
    base = np.asarray(g.base).reshape(-1)
    return [src[base + off] for off in (0, 1, Ws, Ws + 1)]


def test_bias_add_equals_jax_combine_taps(params):
    """At every pixel of the ROI warp grid, random taps, and at each of
    its tiny-weight pixels on the taps nearest a rint tie: the biased
    combine equals JAX's ``combine_taps(..., bias=)`` under jit."""
    jp, tp = params
    jg, tg = jp.grid_warp_roi, tp.grid_warp_roi
    bias = np.asarray(jp.warp_b_bias)
    run = jax.jit(lambda p0, p1, p2, p3, g, b: j_resample.combine_taps(
        p0, p1, p2, p3, g, bias=b))
    rng = np.random.default_rng(7)
    for _ in range(2):
        taps = _random_taps(jg, rng)
        want = np.asarray(run(*(t.reshape(jg.base.shape) for t in taps), jg,
                              bias)).reshape(-1)
        got = t_resample.combine_taps(
            *(torch.from_numpy(t)[:, None] for t in taps), tg,
            bias=tp.warp_b_bias[:, None])[:, 0].numpy()
        np.testing.assert_array_equal(got, want)
    idx = tg.rounded.numpy()
    assert len(idx) > 0
    sub = t_resample.ResampleGrid(
        (2 * np.arange(len(idx), dtype=np.int32))[None],
        *(getattr(tg, k).numpy()[idx][None].astype(np.float32)
          for k in ("w00", "w01", "w10", "w11")),
        src_size=(2 * len(idx), 2))
    near = _near_ties(sub, len(idx), rng)[..., 0]  # (keep, n, 4)
    jsub = j_resample.ResampleGrid(
        *(jax.numpy.asarray(getattr(sub, k).numpy().astype(
            np.float32 if k != "base" else np.int32).reshape(1, -1))
          for k in ("base", "w00", "w01", "w10", "w11")),
        src_size=sub.src_size)
    b_idx = bias.reshape(-1)[idx][None]
    for taps in near:
        want = np.asarray(run(*(taps[None, :, s] for s in range(4)), jsub,
                              b_idx))
        got = t_resample.combine_taps(
            *(torch.from_numpy(taps[:, s])[:, None] for s in range(4)), sub,
            bias=torch.from_numpy(b_idx[0])[:, None])[:, 0].numpy()
        np.testing.assert_array_equal(got, want[0])


def test_pair_gather_with_bias_matches_jax(params):
    jp, tp = params
    Ws, Hs = jp.grid_warp_roi.src_size
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (Hs, Ws), dtype=np.uint8)
    b = rng.integers(0, 256, (Hs, Ws), dtype=np.uint8)
    ja, jb = jax.jit(lambda x, y, g, bb: j_resample.bilinear_gather_pair(
        x, y, g, bias_b=bb))(a, b, jp.grid_warp_roi, jp.warp_b_bias)
    ta, tb = t_resample.bilinear_gather_pair(
        torch.from_numpy(a), torch.from_numpy(b), tp.grid_warp_roi,
        bias_b=tp.warp_b_bias)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    tm.assert_warp_contract("pair channel b", jb, tb.numpy())


def test_warp_channels_match_jax_and_fill_128(params):
    jp, tp = params
    frames = np.concatenate([tm.stills(), np.zeros_like(tm.stills()[:1])])
    _, tb = tm.assert_warp_channels_match(jp, tp, frames)
    g = tp.grid_warp_roi
    outside = ((g.w00 + g.w01 + g.w10 + g.w11) == 0).reshape(g.dst_shape)
    assert 0.05 < float(outside.float().mean()) < 0.5
    assert bool((tb[:, outside] == 128).all())


@pytest.fixture(scope="module")
def chunks():
    return tm.run_chunks(PIPELINE)


def test_chunk_matches_jax(chunks, params):
    tm.assert_chunks_match(*chunks, params[1].warped_size[1])


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    return tm.drive_both(PIPELINE, tmp_path_factory.mktemp(PIPELINE))


def test_process_matches_jax(drives):
    _, j, t = drives
    tm.assert_process_matches(j, t)
    for i in (0, 5):
        np.testing.assert_array_equal(t["pictures"][i], j["pictures"][i])
    assert t["pictures"][2].shape == j["pictures"][2].shape == (1372, 1280, 3)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_continues_in_the_other_package(drives, direction):
    tm.assert_snapshot_continues(PIPELINE, drives, direction)


def test_rows_and_fleet_equal_unsharded(params):
    """A two-stream fleet over two CPU devices equals ``chunk_process`` on
    each stream's frames."""
    _, tp = params
    _, tcfg = tm.configs(PIPELINE)
    frames = tm.chunk_frames()[1:5]  # frame 2 is black
    tm.assert_fleet_equals_chunks(tp, tcfg, np.stack([frames[:2],
                                                      frames[2:]]))


def test_cli_turbo_logs_match_jax(tmp_path):
    src = tmp_path / "in.npz"
    np.savez(src, frames=tm.stills()[:2])
    logs = {}
    for who, run, extra in (("jax", j_run, []),
                            ("port", t_cli.run, ["--device", "cpu"])):
        logs[who] = tmp_path / f"{who}.jsonl"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = run([str(src), str(tmp_path / f"{who}.npz"),
                      "--calibration", str(ASSETS_DIR / "calibration.npz"),
                      "--pipeline", "turbo", "--chunk", "2",
                      "--per-frame-log", str(logs[who])] + extra)
        assert rc in (0, None), who
    jl, tl = (logs[w].read_text().splitlines() for w in ("jax", "port"))
    assert len(tl) == 2 and tl == jl
    assert all(json.loads(x)["valid"] for x in tl)
