"""The port's CUDA kernels on the card against their plain twins.

Marked ``cuda``: without a CUDA device every test skips.  This file
imports no jax (the card's machine has none); run it there without the
suite's jax-forcing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: exact equality (the filter kernels are integer; the banded
warp's pass 2 takes its fma in the twin's order), on the stills' corridor
channels at the slice's shapes and on random images whose sizes are not
multiples of the tiles; the integer decision traces of the stills chunk
and of the fail16 chunk (every 16th frame black, so the second attempt
runs) on the card equal the CPU run's.  The fused channel stage also
equals the unfused kernels, at tile heights from 1 row to the tallest.
The redesigned tophat (k = 1, 3, 5, 29, 55, 63) and cross threshold (k =
1, 15, 35, 65, plain, with the noise mask, as thr_merge_open's first
launch and as riders) equal their twins on ragged shapes (W = 1, 3, 5, 67, 673 and
672, H below k, T = 1 and 64, data off 16-byte alignment), give the same
bits twice, and launch as many kernels as the library's launchers count;
too large a k is refused before any launch.  The bit-packed merge + open
+ prefix tail (open_k = 1, 3, 5, 29, 63) equals the twins on the same
ragged shapes and at the 'fast' width (1080), with and without keep, off
16-byte alignment; the library counts 2 launches for thr_merge_open and 1
for merge_open.
The morphology probes' kernels (every runnable shift-chain variant, the
staged tophat in bf16 and f32 at k = 3, 29, 55 and 63, the dual tophat
at (29, 55) and (55, 29)) equal their twins exactly, at full size and on
ragged blocks (W no multiple of 16, H no multiple of the tile, data off
16-byte alignment), with rolls and slices at least a line long, at the
lines' length limit of 8192 (8193 refused), with rolls whose gcd with a
ragged line is above 1, and the 2-D chain on blocks smaller than its cone
(its kernel launches those of the model's plan); the
staged and dual tophats take one launch a call, and the library's tile
plan for each lane width, and its chain plans (``shift_chain.chain_plan``),
are tests/torch_filter_models.py's; the rejected
variant raises before any launch.  Probe 6's ``sweep_dots``, in every
kind at full size and on a ragged frame: swept equal to the twin's, out
equal for ``sweeps`` and within a relative 1e-4 of the float64 twin for
``dots`` and ``both`` (f32 accumulation on the tensor cores), the same
bits on a second call.  Probe 11's ``tile_gather``: every op at both
chain lengths equal to its twin, and at reps 0, 1, 16 and 64 on (8, 128),
(128, 1280) and (40, 384), also with src near the int32 limits and indices
above the tile (tests/test_torch_gather_design.py's inputs).  One launch
per call.
``timing.queued_ms`` times calls queued behind its spin kernel.
The opt-in modes: the latency mode's bf16 one-hot contractions give the
gather's warped channels bit for bit ('fast', 'turbo', 'half'; T=1 and
8), and 'turbo' and 'half' chunks give the CPU's decisions and integer
state.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch
from torch_filter_models import GATHER_REPS, GATHER_SHAPES, gather_inputs

from lane_tracker_tpu_torch.calib.io import load_calibration_npz
from lane_tracker_tpu_torch.kernels import channel_fused as cf
from lane_tracker_tpu_torch.kernels import filter_stage as fs
from lane_tracker_tpu_torch.kernels import resample_mxu2 as rm
from lane_tracker_tpu_torch.kernels import shift_chain as sc
from lane_tracker_tpu_torch.kernels import sweep_dots as sd
from lane_tracker_tpu_torch.kernels import tile_gather as tg
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
    """(CPU params, card params, the stills cycled to 8 frames on the CPU);
    the params are built twice, once with ``device="cpu"`` and once with
    the entry point's default, the card."""
    cam, warp = load_calibration_npz(ASSETS / "calibration.npz")
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)
    params = TrackerParams.build(*args, pipeline="corridor", device="cpu")
    gparams = TrackerParams.build(*args, pipeline="corridor")
    assert gparams.fwd_u.is_cuda
    with np.load(ASSETS / "stills_720p.npz") as z:
        frames = torch.from_numpy(z["frames"][np.arange(8) % 4])
    return params, gparams, frames


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
    _, gparams, frames = setup
    r, b = warp_channels(frames.cuda(), gparams)
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


def _chunk_on_card_and_cpu(params, gparams, frames):
    cfg = PRESETS["demo1"]
    _, cpu = chunk_process(make_initial_state(cfg, params.warped_size, "cpu"),
                           frames, params, cfg, second_attempt="two_phase")
    fs.reset_launches()
    _, gpu = chunk_process(make_initial_state(cfg, gparams.warped_size),
                           frames.cuda(), gparams, cfg,
                           second_attempt="two_phase")
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
    params, gparams, frames = setup
    frames = frames.clone()
    frames[::16] = 0
    gpu, launches = _chunk_on_card_and_cpu(params, gparams, frames)
    assert not gpu.a1_valid[:2].any()
    assert launches == {name: 0 for name in fs.REPLACES} | {
        name: 1 for name in ATTEMPT1} | {"adaptive_mean": 2,
                                         "merge_open": 1}


# ---- the redesigned tophat and cross threshold on ragged shapes ----

# (T, H, W): W = 1, 3, 5, 67, 673 (no multiple of 4 or 16: the kernels'
# byte paths), H below every large k, T = 1 and 64; 672 (the corridor's
# width) takes the 16-byte path.
RAGGED_SHAPES = [(1, 20, 1), (64, 9, 3), (1, 50, 5), (64, 21, 67),
                 (1, 40, 673), (2, 37, 672)]


def _misaligned(x):
    """x's values in a contiguous tensor whose data starts one byte past a
    16-byte boundary (the kernels' byte path even when W % 16 == 0)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


def _counted(fn):
    """(fn's result, the kernel launches it made, read from the library's
    own counter)."""
    n0 = fs.kernel_launches()
    out = fn()
    return out, fs.kernel_launches() - n0


@pytest.mark.parametrize("k", [1, 3, 5, 29, 55, 63])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_tophat_equals_twin_on_ragged_shapes(cuda, shape, k):
    img = _stripes(shape, sum(shape) + k)
    want = fs.tophat_ellipse_plain(img, k)
    x = img.to(cuda)
    got, n = _counted(lambda: fs.tophat_ellipse(x, k))
    assert n == 1
    _same(got.cpu(), want)
    _same(fs.tophat_ellipse(x, k), got)  # the same bits again
    _same(fs.tophat_ellipse(_misaligned(x), k), got)


@pytest.mark.parametrize("k", [1, 15, 35, 65])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_threshold_equals_twin_on_ragged_shapes(cuda, shape, k):
    img = _stripes(shape, sum(shape) * k)
    g = torch.Generator().manual_seed(k)
    r_th = (torch.rand(shape, generator=g) < 0.1).to(torch.uint8) * 255
    keep = (torch.rand(shape, generator=g) < 0.9).to(torch.uint8) * 255
    x, r_g, keep_g = img.to(cuda), r_th.to(cuda), keep.to(cuda)
    for nt in (-1, 140):
        want = fs.bilateral_threshold_plain(img, k, 5, nt)
        got, n = _counted(lambda: fs.bilateral_threshold(x, k, 5, nt))
        assert n == 1
        _same(got.cpu(), want)
        _same(fs.bilateral_threshold(x, k, 5, nt), got)
        _same(fs.bilateral_threshold(_misaligned(x), k, 5, nt), got)
    for kp, kp_g in ((keep, keep_g), (None, None)):
        want = fs.thr_merge_open_plain(r_th, img, k, 5, kp)
        got, n = _counted(lambda: fs.thr_merge_open(r_g, x, k, 5, kp_g))
        assert n == 2  # the threshold, the merge + open + prefix tail
        _same(got[0].cpu(), want[0])
        _same(got[1].packed.cpu(), want[1].packed)
    riders = [(x, k, 5, -1), (x, k, 8, 140)]
    got, n = _counted(lambda: fs.tophat_riders(x, 29, riders))
    assert n == 3
    for g_, w in zip(got, fs.tophat_riders_plain(
            img, 29, [(img, *rd[1:]) for rd in riders])):
        _same(g_.cpu(), w)


@pytest.mark.parametrize("k", [1, 3, 5, 29, 63])
@pytest.mark.parametrize("shape", RAGGED_SHAPES + [(2, 45, 1080)])
def test_open_tail_equals_twin_on_ragged_shapes(cuda, shape, k):
    g = torch.Generator().manual_seed(sum(shape) + k)
    r_th = (torch.rand(shape, generator=g) < 0.7).to(torch.uint8) * 255
    b_th = torch.randint(0, 3, shape, dtype=torch.uint8, generator=g)
    keep = (torch.rand(shape, generator=g) < 0.98).to(torch.uint8) * 255
    r_g, b_g, keep_g = r_th.to(cuda), b_th.to(cuda), keep.to(cuda)
    for kp, kp_g in ((keep, keep_g), (None, None)):
        want = fs.merge_open_plain(r_th, b_th, kp, k)
        got, n = _counted(lambda: fs.merge_open(r_g, b_g, kp_g, k))
        assert n == 1
        _same(got[0].cpu(), want[0])
        _same(got[1].packed.cpu(), want[1].packed)
        again = fs.merge_open(_misaligned(r_g), _misaligned(b_g),
                              None if kp_g is None else _misaligned(kp_g), k)
        _same(again[0], got[0])
        _same(again[1].packed, got[1].packed)
    merged = torch.where((r_th > 0) | (b_th > 0), 255, 0).to(torch.uint8)
    out, pref = fs._launch_open_prefix(merged.to(cuda), k)
    want = fs.merge_open_plain(r_th, b_th, None, k)
    _same(out.cpu(), want[0])
    _same(pref.cpu(), want[1].packed)


@pytest.mark.parametrize("k", [1, 3, 15, 35, 127])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_adaptive_mean_equals_twin_on_ragged_shapes(cuda, shape, k):
    """The redesigned adaptive mean (replicate clamp at ragged edges, byte
    staging where W % 16 != 0 or the data is misaligned) equals its twin
    at every k up to the kernel's limit, one launch a call, which the
    library's own count sees."""
    img = _stripes(shape, sum(shape) + k)
    want = fs.adaptive_mean_plain(img, k, -5)
    x = img.to(cuda)
    fs.reset_launches()
    got, n = _counted(lambda: fs.adaptive_mean(x, k, -5))
    assert fs.LAUNCHES["adaptive_mean"] == 1 and n == 1
    _same(got.cpu(), want)
    _same(fs.adaptive_mean(_misaligned(x), k, -5), got)
    for C in (300, -300, 7):  # idelta past +-256 decides every pixel
        _same(fs.adaptive_mean(x, k, C).cpu(), fs.adaptive_mean_plain(img, k, C))


@pytest.mark.parametrize("T", [1, 64])
def test_adaptive_mean_tile_rows_fill_the_card(cuda, T):
    """At T=1 ('cond') and T=64 (the batched fallback) on the corridor's
    (1100, 672) frames, both path ks equal the twin; the host's tile
    height is tests/torch_filter_models.py's adaptive_mean_rows."""
    from torch_filter_models import adaptive_mean_rows

    img = _stripes((T, 1100, 672), T)
    x = img.to(cuda)
    for k in (F2.ksize_r, F2.ksize_b):
        _same(fs.adaptive_mean(x, k, -5).cpu(),
              fs.adaptive_mean_plain(img, k, -5))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert adaptive_mean_rows(T, 1100, 672, sms) == (32 if T == 1 else 128)


def test_merge_entries_launch_counts(cuda):
    """thr_merge_open: the threshold and the tail with the merge in its
    load, 2 launches; merge_open: that tail alone, 1."""
    x = _stripes((2, 60, 96), 3).to(cuda)
    n_thr = _counted(lambda: fs.thr_merge_open(x, x, 15, 5, x, open_k=5))[1]
    n_mo = _counted(lambda: fs.merge_open(x, x, x, open_k=5))[1]
    assert (n_thr, n_mo) == (2, 1)


def test_filter_kernels_reject_large_k_before_launch(cuda):
    x = torch.zeros((1, 64, 64), dtype=torch.uint8, device=cuda)
    fs.reset_launches()
    n0 = fs.kernel_launches()
    for fn in (lambda: fs.tophat_ellipse(x, fs.TOPHAT_MAX_K + 2),
               lambda: fs.tophat_ellipse(x, 30),
               lambda: fs.bilateral_threshold(x, fs.THRESHOLD_MAX_K + 1, 5),
               lambda: fs.thr_merge_open(x, x, fs.THRESHOLD_MAX_K + 1, 5),
               lambda: fs.thr_merge_open(x, x, 5, 5, open_k=fs.OPEN_MAX_K + 2),
               lambda: fs.merge_open(x, x, open_k=fs.OPEN_MAX_K + 2),
               lambda: fs.merge_open(x, x, open_k=4),
               lambda: fs.tophat_riders(
                   x, 29, [(x, fs.THRESHOLD_MAX_K + 1, 5, -1)]),
               lambda: fs.adaptive_mean(x, fs.ADAPTIVE_MEAN_MAX_K + 2, 5)):
        with pytest.raises(ValueError, match="ksize"):
            fn()
    assert fs.kernel_launches() == n0
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES}


def test_wrappers_launch_on_their_inputs_device(cuda):
    """Inputs on the card and on the CPU raise before any launch.  With a
    second card, a call on its tensors while the first is current
    launches there and equals the twin (one card: that part cannot run,
    tests/test_torch_launch_device.py holds the device switch on the
    CPU)."""
    x = _stripes((2, 60, 96), 3).to(cuda)
    fs.reset_launches()
    n0 = fs.kernel_launches()
    for fn in (lambda: fs.merge_open(x, x.cpu()),
               lambda: fs.thr_merge_open(x, x.cpu(), 35, 5),
               lambda: fs.tophat_riders(x, 29, [(x.cpu(), 15, 8, -1)]),
               lambda: fs.dual_tophat(x, x.cpu(), 29, 55)):
        with pytest.raises(ValueError, match="several devices"):
            fn()
    assert fs.kernel_launches() == n0
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES}
    if torch.cuda.device_count() > 1:
        y = x.to("cuda:1")
        with torch.cuda.device(0):
            got = fs.tophat_ellipse(y, 29)
            torch.cuda.synchronize(y.device)
        assert got.device == y.device
        assert torch.equal(got.cpu(), fs.tophat_ellipse_plain(x.cpu(), 29))


def test_dual_tophat_launch_count(cuda):
    """The dual tophat makes 1 kernel launch for both problems; two calls
    of the one-launch tophat make 2."""
    a = _stripes((2, 60, 96), 1).to(cuda)
    b = _stripes((2, 60, 96), 2).to(cuda)
    _, n_dual = _counted(lambda: fs.dual_tophat(a, b, 29, 55))
    _, n_sep = _counted(lambda: (fs.tophat_ellipse(a, 29),
                                 fs.tophat_ellipse(b, 55)))
    assert (n_dual, n_sep) == (1, 2)


CHANNELS = (  # (kt, kb, C, noise) of demo1's R and LAB-B channels
    (F.tophat_r, F.ksize_r, F.C_r, None),
    (F.tophat_b, F.ksize_b, F.C_b, (F.ksize_noise, F.C_noise,
                                     F.noise_thresh)),
)


def _stripes(shape, seed):
    """Random u8 channels in [100, 200) with bright vertical stripes, so
    the tophat and both thresholds have hits and misses."""
    rng = np.random.default_rng(seed)
    x = rng.integers(100, 200, shape).astype(np.int32)
    for t in range(shape[0]):
        for _ in range(3):
            c = int(rng.integers(0, shape[2]))
            x[t, :, c:c + int(rng.integers(2, 9))] += int(rng.integers(30, 60))
    return torch.from_numpy(np.clip(x, 0, 255).astype(np.uint8))


def _check_channel_stage(img):
    """Both channels through channel_stage (with the noise mask on B) and
    channel_stage_pyr, at several tile heights: each equals its plain twin
    and the unfused kernels."""
    cf.reset_launches()
    n = 0
    for kt, kb, C, noise in CHANNELS:
        want = cf.channel_stage_plain(img, kt, kb, C, noise=noise)
        want = want if noise else (want,)
        unfused = (fs.bilateral_threshold(fs.tophat_ellipse(img, kt), kb, C),)
        if noise:
            unfused += (fs.bilateral_threshold(img, *noise),)
        for w, u in zip(want, unfused):
            _same(u, w)
        for block in (None, 1, 7, 33, 10 ** 6):
            got = cf.channel_stage(img, kt, kb, C, noise=noise, block=block)
            for g, w in zip(got if noise else (got,), want):
                _same(g, w)
            _same(cf.channel_stage_pyr(img, kt, kb, C, block=block), want[0])
            n += 1
    r_args = CHANNELS[0][:3]
    _same(cf.channel_stage(img[0], *r_args),
          cf.channel_stage_plain(img[0], *r_args))
    kt, kb, C, noise = CHANNELS[1]
    got = cf.channel_stage(_misaligned(img), kt, kb, C, noise=noise)
    for g, w in zip(got, cf.channel_stage_plain(img, kt, kb, C, noise=noise)):
        _same(g, w)
    assert cf.LAUNCHES == {"channel_stage": n + 2, "channel_stage_pyr": n}


def test_channel_stage_equals_twin_and_unfused_on_stills(setup):
    _, gparams, frames = setup
    r, b = warp_channels(frames[:2].cuda(), gparams)
    _check_channel_stage(r)
    _check_channel_stage(b)


@pytest.mark.parametrize("shape", [(2, 77, 101), (3, 33, 64), (1, 300, 5),
                                   (1, 20, 30), (2, 37, 672), (1, 40, 673)])
def test_channel_stage_equals_twin_on_ragged_random(cuda, shape):
    _check_channel_stage(_stripes(shape, sum(shape)).to(cuda))


@pytest.mark.parametrize("block", [None, 1, 7, 96, 10 ** 6])
@pytest.mark.parametrize("shape", [(1100, 672), (77, 101), (1, 5)])
def test_channel_stage_tile_is_the_models(cuda, shape, block):
    """The host's tile plan is tests/torch_filter_models.py's cs_plan (the
    plan the CPU model is held to the twin with)."""
    from torch_filter_models import cs_plan

    H, W = shape
    for kt, kb, _, noise in CHANNELS:
        kn = noise[0] if noise else 0
        p = cs_plan(kt, kb, kn, H, W, block or 0)
        assert cf.tile(H, W, kt, kb, kn, block) == (16 * p["tq"], p["th"])


@pytest.mark.parametrize("T,C,Ho,Ws,Wo", [(2, 2, 37, 150, 200),
                                          (1, 1, 3, 2, 1),
                                          (3, 2, 130, 700, 300)])
def test_banded_pass2_equals_twin_on_random(cuda, T, C, Ho, Ws, Wo):
    rng = np.random.default_rng(T * Ho + Ws)
    n_tiles = -(-Wo // rm.LANE)
    t1 = rng.uniform(-2.0, 258.0, (T, C, Ho, Ws)).astype(np.float32)
    wpack = np.zeros((Ho, n_tiles, 4, rm.LANE), np.float32)
    wpack[:, :, 0] = rng.integers(0, Ws - 1, (Ho, n_tiles, rm.LANE))
    wpack[:, :, 1:3] = rng.uniform(0.0, 1.0, (Ho, n_tiles, 2, rm.LANE))
    t1, wpack = torch.from_numpy(t1), torch.from_numpy(wpack)
    rm.reset_launches()
    got = rm.pass2(t1.to(cuda), wpack.to(cuda), Wo)
    assert rm.LAUNCHES["banded_pass2"] == 1
    _same(got.cpu(), rm.pass2_plain(t1, wpack, Wo))
    _same(got, rm.pass2_plain(t1.to(cuda), wpack.to(cuda), Wo))


def test_mxu_warp_on_card_equals_cpu(setup):
    """MxuWarp2 at a reduced bird's-eye size, built with the default
    device and with device="cpu", on the stills' (R, B) pairs."""
    _, _, frames = setup
    cam, warp = load_calibration_npz(ASSETS / "calibration.npz")
    tables = rm.build_tables(cam.cam_matrix, cam.dist_coeffs, warp.M,
                             warp.image_width_height, (256, 96))
    pairs = frames[:2, ..., [0, 2]].permute(0, 3, 1, 2).contiguous()
    want = rm.MxuWarp2(tables, device="cpu")(pairs)
    gwarp = rm.MxuWarp2(tables)
    assert gwarp.wpack.is_cuda
    rm.reset_launches()
    got = gwarp(pairs.cuda())
    assert rm.LAUNCHES["banded_pass2"] == 1
    assert tuple(got.shape) == (2, 2, 96, 256)
    _same(got.cpu(), want)


# ---- the morphology probes (kernels/shift_chain.py, tophat_staged,
# dual_tophat) ----

CHAINS = [v.name for v in sc.VARIANTS if not v.rejected]
# Ragged blocks: lines (rows of W, columns of H) that fill no CTA evenly.
RAGGED = [(37, 45), (300, 131), (5, 1500)]


def _chain_input(v, shape, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, v.high, shape)
    return torch.from_numpy(vals).to(sc.DTYPES[v.dtype])


def _check_chain_kernel(x, v, k):
    kernel = "shift_chain_2d" if v.body == "morph_chain8" else "shift_chain"
    sc.reset_launches()
    got = sc.shift_chain(x, v, k)
    assert sc.LAUNCHES == {"shift_chain": 0, "shift_chain_2d": 0} | {
        kernel: 1}
    torch.testing.assert_close(got.cpu(), sc.shift_chain_plain(x.cpu(), v, k),
                               rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, sc.shift_chain_plain(x, v, k), rtol=0,
                               atol=0, equal_nan=True)


@pytest.mark.parametrize("name", CHAINS)
def test_shift_chain_equals_twin_on_ragged_blocks(cuda, name):
    v = sc.BY_NAME[name]
    for i, shape in enumerate(RAGGED):
        _check_chain_kernel(_chain_input(v, shape, i).to(cuda), v, 12)


@pytest.mark.parametrize("name", CHAINS)
def test_shift_chain_equals_twin_at_full_size(cuda, name):
    v = sc.BY_NAME[name]
    _check_chain_kernel(sc.make_input(v, device=cuda), v, sc.K)


@pytest.mark.parametrize("name", ["i32_lane_roll_add_s17",
                                  "u8_sublane_roll_min_s17",
                                  "bf16_roll_sub_minmax",
                                  "i32_packed_u16_shift_add_s17",
                                  "int16_lane_slice_min_s17",
                                  "bf16_sub_max_s3"])
def test_shift_chain_shift_at_least_a_line(cuda, name):
    """Rolls by a line's length and more wrap; slices that long read only
    the fill."""
    v = sc.BY_NAME[name]
    for shift in (45, 46, 101):
        shifts = (shift, shift + 1) if v.body == "packed" else (shift,)
        w = dataclasses.replace(v, shifts=shifts, margin=shift)
        _check_chain_kernel(_chain_input(w, (37, 45), shift).to(cuda), w, 8)


# One variant a (type, boundary, axis) kind that a long line reaches.
LONG = ["i32_lane_roll_add_s17", "i32_sublane_roll_add_s17",
        "uint8_lane_slice_min_s17", "uint8_sub_slice_min_s17",
        "i16_sublane_roll_add_s17", "bf16_sub_min_s17",
        "bf16_roll_sub_minmax", "i32_packed_u16_shift_add_s17",
        "f32_lane_roll_min_s17", "i32_lane_roll_add_s128_fine"]


@pytest.mark.parametrize("name", LONG)
def test_shift_chain_at_the_length_limit(cuda, name):
    """A line of 8192 elements (the kernels' limit) along the variant's
    axis equals the twin; one longer is refused before any launch."""
    v = sc.BY_NAME[name]
    limit = (3, 8192) if v.axis == 1 else (8192, 3)
    _check_chain_kernel(_chain_input(v, limit, 1).to(cuda), v, 8)
    over = (3, 8193) if v.axis == 1 else (8193, 3)
    sc.reset_launches()
    with pytest.raises(RuntimeError, match="lt_shift_chain"):
        sc.shift_chain(_chain_input(v, over, 2).to(cuda), v, 8)
    assert sc.LAUNCHES == {"shift_chain": 0, "shift_chain_2d": 0}


@pytest.mark.parametrize("name", ["i32_lane_roll_add_s17",
                                  "u8_sublane_roll_min_s17",
                                  "bf16_roll_sub_minmax",
                                  "i16_lane_roll_min_s17",
                                  "f32_sublane_roll_min_s17"])
@pytest.mark.parametrize("length,lines,shift", [
    (45, 37, 15), (45, 37, 9), (300, 300, 128), (1500, 131, 8),
    (1500, 131, 1000), (1500, 131, 750)])
def test_shift_chain_roll_with_cycles(cuda, name, length, lines, shift):
    """Rolls whose shift shares a factor with a ragged line of ``length``
    (gcd 15, 9, 4, 4, 500 and 750: several cycles a line, some shorter
    than a lane's run; 500 cycles of 3 and 750 of 2 need more than a
    warp's lanes and take the plain order)."""
    v = dataclasses.replace(sc.BY_NAME[name], shifts=(shift,))
    shape = (lines, length) if v.axis == 1 else (length, lines)
    _check_chain_kernel(_chain_input(v, shape, shift).to(cuda), v, 12)


@pytest.mark.parametrize("shape", [(5, 9), (12, 20), (37, 45), (1, 1),
                                   (9, 1300)])
def test_shift_chain_2d_on_blocks_smaller_than_its_cone(cuda, shape):
    """bf16_morph_chain8 at K = 64 (16 outer steps: a cone of 144 rows and
    columns, 36 a launch) on blocks smaller than it: the regions wrap
    around the block; the library counts one kernel launch a
    CHAIN2D_STEPS outer steps."""
    from torch_filter_models import CHAIN2D_STEPS

    v = sc.BY_NAME["bf16_morph_chain8"]
    x = _chain_input(v, shape, sum(shape)).to(cuda)
    n0 = fs.kernel_launches()
    _check_chain_kernel(x, v, sc.K)
    # _check_chain_kernel calls the kernel once and the twin on the card
    assert fs.kernel_launches() - n0 == -(-v.n_passes() // CHAIN2D_STEPS)


@pytest.mark.parametrize("shape", [(1104, 1280), (37, 45), (5, 1500),
                                   (8192, 3), (3, 8192), (9, 200)])
def test_chain_plan_is_the_models(cuda, shape):
    """The library's plans (lt_shift_chain_plan, the launchers' own) are
    tests/torch_filter_models.py's, whose CPU models the tests hold to the
    twin: each shift variant's mode and lanes a line (plain order in one
    warp exactly where its lanes fit one), and the 2-D chain's launches
    and tiles at this card's SM count."""
    from torch_filter_models import (CHAIN2D_STEPS, CHAIN_REGS,
                                     chain2d_tiles, chain_mode, chain_orbits)

    h, w = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for v in sc.VARIANTS:
        if v.rejected or v.boundary is None:
            continue
        plan = sc.chain_plan(v, h, w)
        if v.body == "morph_chain8":
            outer = v.n_passes()
            a1, a2 = (s % w for s in v.shifts)
            b1, b2 = (s % h for s in v.shifts)
            model = chain2d_tiles(h, w, min(CHAIN2D_STEPS, outer), a1, a2,
                                  b1, b2, sms)
            assert plan["launches"] == -(-outer // CHAIN2D_STEPS)
            keys = ("th", "tw", "rh", "rww", "col0", "smem")
            assert {k: plan[k] for k in keys} == {k: model[k] for k in keys}
            assert plan["tiles"] == len(model["tiles"])
            continue
        length = w if v.axis == 1 else h
        mode = chain_mode(v, length, v.n_passes())
        assert plan["regs"] == CHAIN_REGS
        if mode == "orbit":
            s = v.shifts[0] % length if v.boundary == "circular" else (
                v.shifts[0])
            assert plan["mode"] == "orbit", v.name
            assert plan["lanes"] == chain_orbits(
                length, s, v.boundary, v.n_passes())["lanes"], v.name
            assert plan["lanes"] <= 32
        else:
            assert plan["lanes"] == -(-length // CHAIN_REGS), v.name
            assert plan["mode"] == (
                "plain_warp" if plan["lanes"] <= 32 else "plain"), v.name
        assert plan["warps"] == -(-plan["lanes"] // 32)


def test_shift_chain_rejects_before_launch(cuda):
    v = sc.BY_NAME["i16_sublane_slice_add_s17"]
    sc.reset_launches()
    with pytest.raises(ValueError, match=v.name):
        sc.shift_chain(sc.make_input(v, device=cuda), v)
    assert sc.LAUNCHES == {"shift_chain": 0, "shift_chain_2d": 0}


@pytest.mark.parametrize("shape", [(2, 77, 101), (1, 300, 5), (3, 33, 64),
                                   (1, 40, 673), (2, 121, 672),
                                   (64, 21, 67)])
def test_tophat_staged_and_dual_equal_twins(cuda, shape):
    """Ragged frames (W no multiple of 16, H no multiple of any tile) and
    a view off 16-byte alignment; one launch a call."""
    a = _stripes(shape, sum(shape))
    b = _stripes(shape, sum(shape) + 1)
    ag, bg = a.to(cuda), b.to(cuda)
    fs.reset_launches()
    n = 0
    for k in (3, 29, 55, 63):
        for dtype in fs.STAGING:
            got, launches = _counted(lambda: fs.tophat_staged(ag, k, dtype))
            assert launches == 1
            _same(got.cpu(), fs.tophat_staged_plain(a, k, dtype))
            _same(fs.tophat_staged(_misaligned(ag), k, dtype), got)
            n += 2
    for ka, kb in ((29, 55), (55, 29)):
        got, launches = _counted(lambda: fs.dual_tophat(ag, bg, ka, kb))
        assert launches == 1
        for g, w in zip(got, fs.dual_tophat_plain(a, b, ka, kb)):
            _same(g.cpu(), w)
        again = fs.dual_tophat(_misaligned(ag), bg, ka, kb)
        _same(again[0], got[0])
        _same(again[1], got[1])
        _same(got[0], fs.tophat_ellipse(ag, ka))
        _same(got[1], fs.tophat_ellipse(bg, kb))
    assert fs.LAUNCHES == {name: 0 for name in fs.REPLACES} | {
        "tophat_staged": n, "dual_tophat": 4, "tophat_ellipse": 4}


@pytest.mark.parametrize("elem", [1, 2, 4])
@pytest.mark.parametrize("shape", [(1100, 1080), (1100, 672), (77, 101),
                                   (5, 3)])
def test_tophat_plan_is_the_models(cuda, shape, elem):
    """The library's tile plan (lt_tophat_plan: tophat_ellipse's and both
    dual problems' at elem 1, tophat_staged's bf16 and f32 at 2 and 4) is
    tests/torch_filter_models.py's tophat_plan, whose CPU model the tests
    hold to the twin."""
    from torch_filter_models import tophat_plan

    for k in (1, 3, 29, 55, 63):
        assert fs.tophat_plan(k, *shape, elem) == tophat_plan(k, *shape, elem)


# ---- probe 6 (kernels/sweep_dots.py) and probe 11 (kernels/tile_gather.py)
# ----

# (frame, tri, block, col0): the probe's full size (tiles of 184 rows),
# and a ragged frame whose last strip is 22 columns wide and whose
# products start and end inside strips (tiles of 8 rows).
OVERLAP = {"full": ((sd.T, sd.ROWS, sd.COLS), (sd.KP, sd.NP), sd.BLOCK,
                    sd.COL0),
           "ragged": ((3, 61, 150), (96, 64), 32, 16)}


@pytest.mark.parametrize("kind", list(sd.KINDS))
@pytest.mark.parametrize("size", list(OVERLAP))
def test_sweep_dots_equals_twin(cuda, size, kind):
    (t, h, w), (kp, n), block, col0 = OVERLAP[size]
    x, tri = sd.make_inputs(t, h, w, kp, n, cuda)
    sd.reset_launches()
    out, swept = sd.sweep_dots(x, tri, kind, block=block, col0=col0)
    assert sd.LAUNCHES == {"sweep_dots": 1}
    want, want_swept = sd.sweep_dots_plain(x, tri, kind, block=block,
                                           col0=col0)
    _same(swept, want_swept)
    if kind == "sweeps":
        _same(out, want)
    else:
        torch.testing.assert_close(out, want, rtol=sd.RTOL, atol=0)
    again, _ = sd.sweep_dots(x, tri, kind, block=block, col0=col0)
    _same(again, out)  # deterministic: no float atomics
    assert sd.LAUNCHES == {"sweep_dots": 2}


def test_sweep_dots_rejects_before_launch(cuda):
    x, tri = sd.make_inputs(1, 64, 256, 128, 128, cuda)
    sd.reset_launches()
    with pytest.raises(ValueError):
        sd.sweep_dots(x, tri, "both", block=24)
    with pytest.raises(ValueError):
        sd.sweep_dots(x[:, :47].contiguous(), tri, "both", block=32)
    assert sd.LAUNCHES == {"sweep_dots": 0}


@pytest.mark.parametrize("reps", tg.REPS)
@pytest.mark.parametrize("op", list(tg.OPS))
def test_tile_gather_equals_twin(cuda, op, reps):
    src, li, si = tg.make_inputs(cuda)
    tg.reset_launches()
    got = tg.tile_gather(src, li, si, op, reps)
    assert tg.LAUNCHES == {"tile_gather": 1}
    _same(got, tg.tile_gather_plain(src, li, si, op, reps))
    _same(got.cpu(), tg.tile_gather_plain(src.cpu(), li.cpu(), si.cpu(), op,
                                          reps))


@pytest.mark.parametrize("wide", [False, True], ids=["probe", "wide"])
@pytest.mark.parametrize("shape", GATHER_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op", list(tg.OPS))
def test_tile_gather_shapes_equal_twin(cuda, op, shape, wide):
    """The redesign on every whole number of tiles the design test models,
    at reps 0, 1, 16 and 64; ``wide``: src near the int32 limits and
    indices with bits above the tile."""
    seed = 8 * list(tg.OPS).index(op) + 2 * GATHER_SHAPES.index(shape) + wide
    host = [torch.from_numpy(a) for a in gather_inputs(shape, seed, wide)]
    src, li, si = (a.to(cuda) for a in host)
    for reps in GATHER_REPS:
        tg.reset_launches()
        got = tg.tile_gather(src, li, si, op, reps)
        assert tg.LAUNCHES == {"tile_gather": 1}
        _same(got.cpu(), tg.tile_gather_plain(*host, op, reps))


def test_queued_ms_times_the_queued_calls(cuda):
    """The calls are queued behind the spin (else ``queued_ms`` raises),
    and a longer chain takes longer on the card."""
    from lane_tracker_tpu_torch.timing import queued_ms

    src, li, si = tg.make_inputs(cuda)

    def fn(n):
        return tg.tile_gather(src, li, si, "G3_2d_gather", n)

    lo, hi = (queued_ms(lambda n=n: fn(n), 10) for n in tg.REPS)
    assert 0 < lo < hi


# ---- the names and paths the port added beside the kernels (gaps) ----


def test_gaps_motion_frames_on_the_card(cuda):
    """Frames 448-451 (a dropout from 450) made on the card equal the CPU
    generator's, every value."""
    from lane_tracker_tpu_torch.io import motion

    t = range(448, 452)
    scenes = motion.load_scenes()
    got = torch.stack([motion.motion_frame(i, scenes) for i in t])
    assert got.is_cuda
    cpu = motion.load_scenes("cpu")
    _same(got.cpu(), torch.stack([motion.motion_frame(i, cpu) for i in t]))


def test_gaps_bilateral_adaptive_threshold_on_the_card(cuda, setup):
    """Mode 'floor' with 255/0 launches the cross-threshold kernel; the
    other forms run the plain arithmetic; both equal the CPU's."""
    from lane_tracker_tpu_torch.ops.threshold import (
        bilateral_adaptive_threshold,
    )

    _, _, frames = setup
    img = frames[:2, 400:700, :, 1].contiguous()
    for kw, launches in (({}, 1), ({"mode": "ceil", "C": 3}, 0),
                         ({"true_value": 1, "false_value": 7}, 0)):
        fs.reset_launches()
        got = bilateral_adaptive_threshold(img.to(cuda), ksize=25, **kw)
        assert fs.LAUNCHES["bilateral_threshold"] == launches
        _same(got.cpu(), bilateral_adaptive_threshold(img, ksize=25, **kw))


def test_gaps_api_names_on_the_card(cuda, setup):
    """``filter_lane_points`` and ``bilinear_gather_pair`` on the card
    equal the CPU's."""
    from lane_tracker_tpu_torch.kernels.resample import bilinear_gather_pair
    from lane_tracker_tpu_torch.ops.filters import filter_lane_points

    params, gparams, frames = setup
    warped = frames[:2, 450:720, 300:700].contiguous()
    for kw in ({}, {"mask_noise": True}):
        _same(filter_lane_points(warped.to(cuda), **kw).cpu(),
              filter_lane_points(warped, **kw))
    r0 = params.raw_roi[0]
    a = frames[0, r0:r0 + params.grid_und_roi.src_size[1], :, 0]
    b = frames[0, r0:r0 + params.grid_und_roi.src_size[1], :, 2]
    got = bilinear_gather_pair(a.to(cuda), b.to(cuda), gparams.grid_und_roi)
    want = bilinear_gather_pair(a, b, params.grid_und_roi)
    for g, w in zip(got, want):
        _same(g.cpu(), w)


# ---- the opt-in modes on the card ('turbo', 'half', the latency mode) ----


def _mode_params(pipeline, **device):
    cam, warp = load_calibration_npz(ASSETS / "calibration.npz")
    return TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline=pipeline, **device)


@pytest.mark.parametrize("pipeline", ["fast", "turbo", "half"])
def test_modes_rowmm_warp_equals_gather_on_the_card(cuda, setup, pipeline):
    """The latency mode's bf16 one-hot contractions on the card give the
    gather's warped channels bit for bit, at T=1 and T=8."""
    from lane_tracker_tpu_torch.tracker.step import warp_channels

    _, _, frames = setup
    gp = _mode_params(pipeline)
    gm = gp.with_rowmm()
    assert gm.mm_und.onehot.is_cuda
    assert gm.mm_und.onehot.dtype == torch.bfloat16
    g = frames.to(cuda)
    for batch in (g[:1], g):
        for got, want in zip(warp_channels(batch, gm),
                             warp_channels(batch, gp)):
            _same(got, want)


@pytest.mark.parametrize("pipeline", ["turbo", "half"])
def test_modes_chunk_on_card_equals_cpu(cuda, setup, pipeline):
    """'turbo' and 'half' (demo1, halved for 'half'), 8 frames with a
    black one: the card's decisions and integer state equal the CPU's."""
    from lane_tracker_tpu_torch.tracker.config import halve_config
    from lane_tracker_tpu_torch.tracker.step import make_initial_state

    _, _, frames = setup
    cfg = PRESETS["demo1"]
    if pipeline == "half":
        cfg = halve_config(cfg)
    frames = frames.clone()
    frames[3] = 0
    runs = []
    for device in ("cpu", "cuda"):
        p = _mode_params(pipeline, device=device)
        runs.append(chunk_process(
            make_initial_state(cfg, p.warped_size, device),
            frames.to(device), p, cfg, second_attempt="two_phase"))
    (cs, co), (gs, go) = runs
    assert not bool(co.a1_valid[3])
    for tree, gtree in ((co, go), (cs, gs)):
        for name, x in zip(tree._fields, tree):
            if x is not None and not x.is_floating_point():
                _same(getattr(gtree, name).cpu(), x)
