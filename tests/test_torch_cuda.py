"""The port's CUDA kernels on the card against their plain twins.

Marked ``cuda``: without a CUDA device every test skips.  This file
imports no jax (the card's machine has none); run it there without the
suite's jax-forcing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: exact equality (the kernels are integer), on the stills'
corridor channels at the slice's shapes and on random images whose sizes
are not multiples of the 32x32 tiles; the integer decision traces of the
stills chunk and of the fail16 chunk (every 16th frame black, so the
second attempt runs) on the card equal the CPU run's.
"""

import copy
import pathlib

import numpy as np
import pytest
import torch

from lane_tracker_tpu_torch.calib.io import load_calibration_npz
from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.kernels.build import build
from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
from lane_tracker_tpu_torch.tracker.config import PRESETS, SECOND_ATTEMPT
from lane_tracker_tpu_torch.tracker.step import (
    TrackerParams,
    make_initial_state,
    warp_channels,
)

ASSETS = pathlib.Path(__file__).resolve().parent.parent / "assets"
F = PRESETS["demo1"].filter
F2 = SECOND_ATTEMPT.filter
ATTEMPT1 = ("tophat_ellipse", "tophat_riders", "thr_merge_open")
DECISIONS = ("valid", "detected", "search_mode", "n_points_left",
             "n_points_right", "corridor_ok", "render_mode", "n_attempts",
             "a1_valid")
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    path, seconds, log = build()
    print(f"built {path.name} in {seconds:.1f} s\n{log}")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(cuda):
    cam, warp = load_calibration_npz(ASSETS / "calibration.npz")
    params = TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="corridor")
    with np.load(ASSETS / "stills_720p.npz") as z:
        frames = torch.from_numpy(z["frames"][np.arange(8) % 4])
    return params, frames


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _check_chain(r, b, f):
    fs.reset_launches()
    r_feat = fs.tophat_ellipse(r, f.tophat_r)
    _same(r_feat, fs.tophat_ellipse_plain(r, f.tophat_r))
    riders = [(r_feat, f.ksize_r, f.C_r, -1),
              (b, f.ksize_noise, f.C_noise, f.noise_thresh)]
    outs = fs.tophat_riders(b, f.tophat_b, riders)
    for g, w in zip(outs, fs.tophat_riders_plain(b, f.tophat_b, riders)):
        _same(g, w)
    b_feat, r_th, keep = outs
    for k in (keep, None):
        got = fs.thr_merge_open(r_th, b_feat, f.ksize_b, f.C_b, k,
                                open_k=f.open_k)
        want = fs.thr_merge_open_plain(r_th, b_feat, f.ksize_b, f.C_b, k,
                                       open_k=f.open_k)
        _same(got[0], want[0])
        _same(got[1].packed, want[1].packed)
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES} | {
        "tophat_ellipse": 1, "tophat_riders": 1, "thr_merge_open": 2}


def _check_second_attempt_kernels(r, b):
    """adaptive_mean (both of the neighborhood filter's calls),
    merge_open with and without keep, bilateral_threshold plain and
    keep."""
    fs.reset_launches()
    r_th = fs.adaptive_mean(r, F2.ksize_r, -F2.C_r)
    _same(r_th, fs.adaptive_mean_plain(r, F2.ksize_r, -F2.C_r))
    b_th = fs.adaptive_mean(b, F2.ksize_b, -F2.C_b)
    _same(b_th, fs.adaptive_mean_plain(b, F2.ksize_b, -F2.C_b))
    keep = fs.bilateral_threshold(b, F.ksize_noise, F.C_noise,
                                  F.noise_thresh)
    _same(keep, fs.bilateral_threshold_plain(b, F.ksize_noise, F.C_noise,
                                             F.noise_thresh))
    b65 = fs.bilateral_threshold(b, 65, F.C_b)
    _same(b65, fs.bilateral_threshold_plain(b, 65, F.C_b))
    for k in (keep, None):
        got = fs.merge_open(r_th, b_th, k, open_k=F2.open_k)
        want = fs.merge_open_plain(r_th, b_th, k, open_k=F2.open_k)
        _same(got[0], want[0])
        _same(got[1].packed, want[1].packed)
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES} | {
        "adaptive_mean": 2, "bilateral_threshold": 2, "merge_open": 2}


def test_kernels_equal_twins_on_stills(setup):
    params, frames = setup
    r, b = warp_channels(frames.cuda(), copy.deepcopy(params).cuda())
    assert tuple(r.shape) == (8, 1100, 672)
    _check_chain(r, b, F)
    _check_second_attempt_kernels(r, b)


@pytest.mark.parametrize("shape", [(2, 77, 101), (3, 33, 64), (1, 300, 5)])
def test_kernels_equal_twins_on_ragged_random(cuda, shape):
    g = torch.Generator().manual_seed(sum(shape))
    r = torch.randint(0, 256, shape, dtype=torch.uint8, generator=g)
    b = torch.randint(100, 180, shape, dtype=torch.uint8, generator=g)
    _check_chain(r.to(cuda), b.to(cuda), F)
    _check_second_attempt_kernels(r.to(cuda), b.to(cuda))


def _chunk_on_card_and_cpu(params, frames):
    cfg = PRESETS["demo1"]
    _, cpu = chunk_process(make_initial_state(cfg, params.warped_size),
                           frames, params, cfg, second_attempt="two_phase")
    fs.reset_launches()
    p = copy.deepcopy(params).cuda()
    _, gpu = chunk_process(make_initial_state(cfg, p.warped_size, "cuda"),
                           frames.cuda(), p, cfg, second_attempt="two_phase")
    for name in DECISIONS:
        _same(getattr(gpu, name).cpu(), getattr(cpu, name))
    torch.testing.assert_close(gpu.left_coeffs.cpu(), cpu.left_coeffs,
                               rtol=1e-4, atol=1e-3)
    return gpu, dict(fs.LAUNCHES)


def test_chunk_on_card_equals_cpu(setup):
    """The stills never fail attempt 1: the second attempt's kernels do
    not launch."""
    gpu, launches = _chunk_on_card_and_cpu(*setup)
    assert gpu.valid.all()
    assert launches == {name: 0 for name in fs.REPLACES} | {
        name: 1 for name in ATTEMPT1}


def test_fail16_chunk_on_card_equals_cpu(setup):
    """Frame 0 is black: two_phase's fallback runs the neighborhood filter
    once on the chunk (two adaptive_mean launches, one merge_open)."""
    params, frames = setup
    frames = frames.clone()
    frames[::16] = 0
    gpu, launches = _chunk_on_card_and_cpu(params, frames)
    assert not gpu.a1_valid[:2].any()
    assert launches == {name: 0 for name in fs.REPLACES} | {
        name: 1 for name in ATTEMPT1} | {"adaptive_mean": 2,
                                         "merge_open": 1}
