"""The warp + LAB-B kernels (kernels/warp_lab.py, csrc/warp_lab.cu).

On the CPU: the premise of the kernels' table LAB-B (the reference's gamma
polynomial is ``gamma_tab`` on all 256 inputs); the dispatch rule ('fast',
'corridor', 'half' and 'compat' qualify, 'turbo' and the row-matmul
latency mode do not, and on the CPU ``warp_rows`` takes the twin and counts
no kernel frames); a model of the kernels' arithmetic on the grids'
buffers (``_model``: the undistort into the band, the warp's fma chain,
the table LAB-B) equals the twin bit for bit at the synthetic geometry, at
full size and on the corpus's 11 stills; ``warp_rows`` with ``out``
writes the twin's planes there; inputs the wrapper does not take raise
before any launch.

Marked ``cuda`` (skip without a card): the kernels' R and LAB-B planes
bit-equal to the twin's on the card and on the CPU in 'fast', 'corridor',
'half' and 'compat', on frames 384-511 of the motion traffic (black at
450-455), on the four stills the card can read (``stills_720p.npz``) and
on random frames, a call of T = 1, 36 and 37 frames at a time; each slice
written into its frames of the chunk's planes (``out``); the launch and
frame counts of one ``process_chunk`` (a call a slice) and of one fleet
step (one call); non-uint8 and non-contiguous inputs and planes raise.  This
file imports no jax; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_warp_lab.py -q -s
"""

import os
import pathlib
import types

import numpy as np
import pytest
import torch

from lane_tracker_tpu_torch.calib import synthetic as syn
from lane_tracker_tpu_torch.kernels import warp_lab as wl
from lane_tracker_tpu_torch.kernels.resample import fma_f32
from lane_tracker_tpu_torch.ops.color import _gamma_poly_f32, _tables
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
ASSETS = ROOT / "assets"
QUALIFY = ("fast", "corridor", "half", "compat")
# 'corridor' at the synthetic geometry (96 warped columns).
TINY_CORRIDOR = (24, 72)
SLOTS = ("w00", "w01", "w10", "w11")
# The corpus's 11 stills (tests/test_corpus.py's frames).
STILLS = ("frame911.jpg", "frame971.jpg", "straight_lines1.jpg",
          "straight_lines2.jpg", "test1.jpg", "test2.jpg", "test3.jpg",
          "test4.jpg", "test5.jpg", "test6.jpg", "test7.jpg")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(pipeline, rowmm=False):
    cam, warp = syn.make_synthetic_calibration()
    kw = {"col_roi": TINY_CORRIDOR} if pipeline == "corridor" else {}
    params = t_step.TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline=pipeline, device="cpu", **kw)
    return params.with_rowmm() if rowmm else params


def _full(pipeline, device="cpu"):
    from lane_tracker_tpu_torch import load_calibration_npz

    cam, warp = load_calibration_npz(ASSETS / "calibration.npz")
    return t_step.TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline=pipeline, device=device)


def _raw(params, frames):
    r0, r1 = params.raw_roi
    return frames[:, r0:r1]


def _random_frames(n, H=720, W=1280, seed=0):
    """Random uint8 frames, the last black: every tap of every warped
    pixel nonzero but the black frame's."""
    frames = np.random.default_rng(seed).integers(0, 256, (n, H, W, 3),
                                                  dtype=np.uint8)
    frames[-1] = 0
    return torch.from_numpy(frames)


def _model(raw: torch.Tensor, chain: t_step.WarpChain) -> tuple:
    """csrc/warp_lab.cu's arithmetic on the CPU, from the chain's grid
    buffers: ``undistort_kernel``'s band, then ``warp_lab_kernel``'s fma
    chain (float32 weights, ``fma_f32``, one rounding each) and its table
    LAB-B."""
    T = raw.shape[0]
    g_und, g_warp = chain.g_und, chain.g_warp
    width = g_und.src_size[0]
    flat = raw.contiguous().reshape(T, -1, 3).int()
    acc = sum(flat[:, g_und.base + off] * getattr(g_und, k)[:, None]
              for k, off in zip(SLOTS, (0, 1, width, width + 1)))
    band = ((acc + (1 << 14)) >> 15).clamp(0, 255)
    bw = g_warp.src_size[0]
    H, W = g_warp.dst_shape
    ws = [getattr(g_warp, k).float()[:, None] for k in SLOTS]
    taps = [band[:, g_warp.base + off].float()
            for off in (0, 1, bw, bw + 1)]
    acc = taps[1] * ws[1]
    for k in (0, 2, 3):
        acc = fma_f32(taps[k], ws[k], acc)
    rgb = torch.round(acc).clamp(0, 255).long()
    gamma, cbrt, C = (torch.from_numpy(np.asarray(x, np.int64))
                      for x in _tables())
    g = gamma[rgb]

    def f(row):
        idx = ((g * C[row]).sum(-1) + (1 << 11)) >> 12
        return cbrt[idx.clamp(0, 3071)]

    b = (200 * (f(1) - f(2)) + (128 << 15) + (1 << 14)) >> 15
    as_u8 = lambda x: x.clamp(0, 255).to(torch.uint8).reshape(T, H, W)
    return as_u8(rgb[..., 0]), as_u8(b)


def _twin(params, frames, batch=16):
    """``warp_rows_plain`` of the frames' raw rows, ``batch`` frames at a
    time (its float64 intermediates grow with the batch)."""
    chain = t_step.warp_chain(params)
    parts = [t_step.warp_rows_plain(_raw(params, frames[k:k + batch]), chain)
             for k in range(0, frames.shape[0], batch)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _assert_equal(got, want, tag):
    for name, g, w in zip(("R", "LAB-B"), got, want):
        assert g.shape == w.shape, (tag, name, g.shape, w.shape)
        diff = (g.cpu() != w.cpu()).sum().item()
        assert diff == 0, f"{tag} {name}: {diff} pixels differ"


# ---- on the CPU ----

def test_gamma_polynomial_is_the_table():
    """The kernels' table LAB-B rests on this: the reference's gamma
    polynomial (``rgb2lab_b_fast``) rounds to ``gamma_tab``
    (``rgb2lab_b_u8``) on every uint8 input."""
    x = torch.arange(256, dtype=torch.float32)
    got = _gamma_poly_f32(x).to(torch.int32)
    assert torch.equal(got, torch.from_numpy(_tables()[0]))


@pytest.mark.parametrize("pipeline,rowmm,qualifies", [
    ("fast", False, True), ("corridor", False, True), ("half", False, True),
    ("compat", False, True), ("turbo", False, False), ("fast", True, False),
    ("turbo", True, False)])
def test_dispatch_rule(pipeline, rowmm, qualifies):
    """A chain qualifies by its own fields alone; a CUDA tensor (here a
    stand-in with a CUDA device) takes the kernels, a CPU one never."""
    params = _tiny(pipeline, rowmm)
    chain = t_step.warp_chain(params)
    assert wl.qualifies(chain) == qualifies
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    assert wl.takes_kernel(cuda, chain) == qualifies
    assert not wl.takes_kernel(torch.zeros(1, dtype=torch.uint8), chain)


@pytest.mark.parametrize("pipeline", QUALIFY)
def test_cpu_warp_rows_takes_the_twin(pipeline, monkeypatch):
    """On the CPU ``warp_channels`` runs the PyTorch chain: the kernels'
    wrapper is never called, nothing is launched or counted."""
    def never(*args, **kwargs):
        raise AssertionError("the kernels' wrapper was called")

    monkeypatch.setattr(t_step, "warp_lab", never)
    params = _tiny(pipeline)
    frames = _random_frames(2, *params.img_size[::-1])
    n = wl.LAUNCHES["warp_lab"]
    with profiling.recording():
        got = t_step.warp_channels(frames, params)
    assert "lt.warp_lab.kernel_frames" not in profiling.summary()["counters"]
    assert wl.LAUNCHES["warp_lab"] == n
    _assert_equal(got, t_step.warp_rows_plain(_raw(params, frames),
                                              t_step.warp_chain(params)),
                  pipeline)


@pytest.mark.parametrize("pipeline", QUALIFY + ("turbo",))
def test_cpu_warp_rows_into_planes(pipeline):
    """``warp_rows`` with ``out`` writes the twin's planes into the given
    ones, a slice of larger planes here, and returns them."""
    params = _tiny(pipeline)
    frames = _random_frames(3, *params.img_size[::-1], seed=6)
    chain = t_step.warp_chain(params)
    want = t_step.warp_rows_plain(_raw(params, frames), chain)
    planes = tuple(torch.full((5,) + chain.g_warp.dst_shape, 7,
                              dtype=torch.uint8) for _ in range(2))
    out = tuple(p[1:4] for p in planes)
    got = t_step.warp_channels(frames, params, out)
    assert all(g is o for g, o in zip(got, out))
    _assert_equal(got, want, pipeline)
    assert all(bool((p[0] == 7).all() and (p[4] == 7).all()) for p in planes)


@pytest.mark.parametrize("pipeline", QUALIFY)
def test_model_equals_twin_tiny(pipeline):
    params = _tiny(pipeline)
    frames = _random_frames(3, *params.img_size[::-1], seed=3)
    raw, chain = _raw(params, frames), t_step.warp_chain(params)
    _assert_equal(_model(raw, chain), t_step.warp_rows_plain(raw, chain),
                  pipeline)


@pytest.mark.parametrize("pipeline", ["fast", "corridor"])
def test_model_equals_twin_full_size(pipeline):
    """At the demo calibration, on random frames (every pixel of
    ``grid.rounded`` taps nonzero values) and a black one."""
    params = _full(pipeline)
    assert params.grid_warp_roi.rounded.numel() > 0
    raw, chain = _raw(params, _random_frames(2, seed=4)), t_step.warp_chain(
        params)
    _assert_equal(_model(raw, chain), t_step.warp_rows_plain(raw, chain),
                  pipeline)


def test_model_equals_twin_on_the_stills():
    """The corpus's 11 stills, 'fast', two at a time."""
    from PIL import Image

    params = _full("fast")
    chain = t_step.warp_chain(params)
    for i in range(0, len(STILLS), 2):
        frames = torch.from_numpy(np.stack([
            np.asarray(Image.open(ASSETS / name).convert("RGB"))
            for name in STILLS[i:i + 2]]))
        raw = _raw(params, frames)
        _assert_equal(_model(raw, chain),
                      t_step.warp_rows_plain(raw, chain), STILLS[i])


def _faults(chain, device="cpu"):
    """Inputs the wrapper does not take, on ``device``: each fault's
    (raw rows, undistort grid, warp grid) and the word its error names."""
    g_und, g_warp = chain.g_und, chain.g_warp
    width, rows = g_und.src_size

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.uint8, device=device)

    ok, wide = zeros(2, rows, width, 3), zeros(2, rows, 2 * width, 3)
    planar = zeros(2, 3, rows, width)
    H, W = g_warp.dst_shape
    plane, wide_plane = zeros(2, H, W), zeros(2, H, 2 * W)
    return {
        "float32": ((ok.float(), g_und, g_warp), "uint8"),
        "two channels": ((ok[..., :2], g_und, g_warp), "uint8"),
        "other width": ((wide, g_und, g_warp), "uint8"),
        "no frames": ((ok[:0], g_und, g_warp), "uint8"),
        "strided columns": ((wide[:, :, ::2], g_und, g_warp), "contiguous"),
        "planar": ((planar.permute(0, 2, 3, 1), g_und, g_warp),
                   "contiguous"),
        "fixed warp grid": ((ok, g_und, type(g_warp)._with(
            g_warp.dst_shape, g_warp.src_size,
            {k: v if k == "base" else v.int()
             for k, v in g_warp.named_buffers()})), "float64"),
        "unchained grids": ((ok, g_und, type(g_warp)._with(
            g_warp.dst_shape, (g_warp.src_size[0], g_warp.src_size[1] + 1),
            dict(g_warp.named_buffers()))), "undistorted image"),
        "int32 planes": ((ok, g_und, g_warp, (plane, plane.int())),
                         "uint8"),
        "other planes": ((ok, g_und, g_warp, (plane, plane[:1])), "uint8"),
        "strided planes": ((ok, g_und, g_warp,
                            (wide_plane[..., ::2], plane)), "contiguous"),
        "one plane": ((ok, g_und, g_warp, (plane,)), "R and LAB-B"),
        "on the CPU": ((ok, g_und, g_warp), "device"),
    }


FAULTS = ("float32", "two channels", "other width", "no frames",
          "strided columns", "planar", "fixed warp grid", "unchained grids",
          "int32 planes", "other planes", "strided planes", "one plane")


@pytest.mark.parametrize("fault", FAULTS + ("on the CPU",))
def test_wrapper_raises_before_any_launch(fault, monkeypatch):
    def never(*args, **kwargs):
        raise AssertionError("launched")

    monkeypatch.setattr(wl, "_call", never)
    args, match = _faults(t_step.warp_chain(_tiny("fast")))[fault]
    n = wl.LAUNCHES["warp_lab"]
    with pytest.raises(ValueError, match=match):
        wl.warp_lab(*args)
    assert wl.LAUNCHES["warp_lab"] == n


# ---- on the card ----

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from lane_tracker_tpu_torch.kernels.build import build

    path, seconds, _ = build()
    print(f"built {path.name} in {seconds:.1f} s")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_frames(card):
    """The three frame sets on the host: frames 384-511 of the motion
    traffic (black at 450-455), the four stills the card can read, and 37
    random frames with a black one."""
    from lane_tracker_tpu_torch.io.motion import load_scenes, motion_frame

    scenes = load_scenes("cuda")
    motion = torch.stack([motion_frame(t, scenes)
                          for t in range(384, 512)]).cpu()
    with np.load(ASSETS / "stills_720p.npz") as z:
        stills = torch.from_numpy(z["frames"])
    return {"motion": motion, "stills": stills,
            "random": _random_frames(37, seed=5)}


@pytest.fixture(scope="module")
def twins(card, card_frames):
    """(card params, the twin's planes on the card, on the CPU) by
    pipeline, each by frame set; the CPU twin on every core."""
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        for name in QUALIFY:
            cpu, card_params = _full(name), _full(name, "cuda")
            out[name] = (card_params, *({
                k: _twin(p, f.to(p.fwd_u.device))
                for k, f in card_frames.items()} for p in (card_params, cpu)))
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 36, 37])
@pytest.mark.parametrize("frames", ["motion", "stills", "random"])
@pytest.mark.parametrize("pipeline", QUALIFY)
def test_kernel_equals_twin(twins, card_frames, pipeline, frames, T):
    """The kernels, T frames a call over the whole set, against the twin
    on the card and on the CPU: every plane equal."""
    params, card_twin, cpu_twin = twins[pipeline]
    chain = t_step.warp_chain(params)
    raw = _raw(params, card_frames[frames].cuda())
    assert wl.takes_kernel(raw, chain)
    parts = [wl.warp_lab(raw[k:k + T], chain.g_und, chain.g_warp)
             for k in range(0, raw.shape[0], T)]
    got = tuple(torch.cat(x) for x in zip(*parts))
    torch.cuda.synchronize()
    _assert_equal(got, card_twin[frames], "card twin")
    _assert_equal(got, cpu_twin[frames], "CPU twin")


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["fast", "corridor"])
def test_kernel_writes_into_planes(twins, card_frames, pipeline):
    """With ``out`` the kernels write each 36-frame slice into its frames
    of the chunk's planes, and nothing else: the planes equal the twin's,
    the frames outside the slices keep what they held."""
    params, card_twin, _ = twins[pipeline]
    chain = t_step.warp_chain(params)
    raw = _raw(params, card_frames["motion"].cuda())
    T = raw.shape[0]
    planes = tuple(torch.full((T + 2,) + chain.g_warp.dst_shape, 7,
                              dtype=torch.uint8, device="cuda")
                   for _ in range(2))
    for k in range(0, T, 36):
        out = tuple(p[1 + k:1 + min(k + 36, T)] for p in planes)
        got = wl.warp_lab(raw[k:k + 36], chain.g_und, chain.g_warp, out)
        assert all(g is o for g, o in zip(got, out))
    torch.cuda.synchronize()
    _assert_equal(tuple(p[1:T + 1] for p in planes), card_twin["motion"],
                  "card twin")
    assert all(bool((p[0] == 7).all() and (p[-1] == 7).all())
               for p in planes)


@pytest.mark.cuda
def test_launches_and_frames_counted(card, card_frames):
    """One ``process_chunk`` of host frames calls the kernels once a slice
    and counts each slice's frames; one fleet step calls them once on its
    whole batch; the library launches two kernels a call."""
    from lane_tracker_tpu_torch import LaneTracker, load_calibration_npz
    from lane_tracker_tpu_torch.parallel.streams import StreamFleet
    from lane_tracker_tpu_torch.tracker import upload
    from lane_tracker_tpu_torch.tracker.config import PRESETS

    cam, warp = load_calibration_npz(ASSETS / "calibration.npz")
    tracker = LaneTracker(warp.image_width_height, warp.warped_width_height,
                          cam.cam_matrix, cam.dist_coeffs, (warp.M, warp.Minv),
                          (warp.mppv, warp.mpph),
                          validity=PRESETS["demo1"].validity)
    frames = card_frames["motion"].numpy()
    slices = -(-len(frames) // upload.slice_frames(frames[0].nbytes))
    fleet = StreamFleet(_full("fast", "cuda"), PRESETS["demo1"], 4,
                        mesh=["cuda"])
    fleet_frames = card_frames["motion"][:64].reshape(4, 16, 720, 1280, 3)
    for name, call, calls, n in (
            ("process_chunk", lambda: tracker.process_chunk(frames), slices,
             len(frames)),
            ("fleet step", lambda: fleet.step(fleet_frames), 1, 64)):
        torch.cuda.synchronize()
        n0, k0 = wl.LAUNCHES["warp_lab"], wl.kernel_launches()
        with profiling.recording():
            call()
        torch.cuda.synchronize()
        c = profiling.summary()["counters"]
        assert wl.LAUNCHES["warp_lab"] - n0 == calls, name
        assert wl.kernel_launches() - k0 == 2 * calls, name
        assert c["lt.warp_lab.kernel_frames"] == c["lt.frames"] == n, name


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_wrapper_raises_on_the_card(card, fault):
    chain = t_step.warp_chain(_full("fast", "cuda"))
    args, match = _faults(chain, card)[fault]
    n, k = wl.LAUNCHES["warp_lab"], wl.kernel_launches()
    with pytest.raises(ValueError, match=match):
        wl.warp_lab(*args)
    assert (wl.LAUNCHES["warp_lab"], wl.kernel_launches()) == (n, k)
