"""The back half's scan kernel (kernels/back_half.py, csrc/back_half.cu).

On the CPU, at the port's synthetic 128x96 calibration: the state packing
round trip; the dispatch rule (on the CPU every schedule takes the plain
twins; 'cond' with a second attempt and no attempt-2 artifacts is never
eligible); inputs the kernel does not take raise before any launch; with
the launch stubbed, the wrapper's tables, its outputs' types and shapes
(the twins') and the ``lt.back_half.kernel_frames`` counter; the
benchmark's reader of ``back_half_kernel_share``.

Marked ``cuda`` (skip without a card): the kernel against the twins on
motion chunks that hold scene 1 and black frames (both attempts, band
and blind search, grace-period draws and failures), in 'fast',
'corridor', 'compat', 'turbo' and 'half', with one attempt and with the
hoisted second attempt, for one stream (T = 64) and sixteen (T = 32):
every int and bool of the outputs and of the end state equal, the fits
and graphs within 1e-2 px over the warped rows, the shown radius within
the benchmark check's ``radius_rel`` limit; the launch counted in the
kernel's own counter and not in the filter stage's.  This file imports
no jax; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_back_half.py -q -s
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from lane_tracker_tpu_torch.calib import synthetic as syn
from lane_tracker_tpu_torch.kernels import back_half as bhk
from lane_tracker_tpu_torch.parallel import pipeline
from lane_tracker_tpu_torch.parallel.pipeline import (
    chunk_process,
    scan_back_half_plain,
)
from lane_tracker_tpu_torch.parallel.streams import (
    StreamFleet,
    scan_streams_plain,
)
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.tracker.state import TrackerState
from lane_tracker_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The benchmark check's limit on the shown radius (benchmark/configs/).
RADIUS_REL = 3.0
CURVE_PX = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lane_frames(n, H=96, W=128, seed=0):
    """Two bright lane stripes over dark noise (tests/test_torch_fleet.py's
    frames)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(20, 60, (n, H, W, 3), dtype=np.uint8)
    for t in range(n):
        for xfrac in (0.40, 0.60):
            for y in range(H // 2, H):
                depth = (y - H // 2) / (H / 2)
                x = int(W / 2 + (xfrac - 0.5) * W * depth)
                frames[t, y, max(x - 1, 0):min(x + 2, W), :] = 230
    return frames


@pytest.fixture(scope="module")
def tiny():
    """(params, config, hoisted artifacts of 4 frames) at the synthetic
    calibration on the CPU."""
    cam, warp = syn.make_synthetic_calibration()
    params = t_step.TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="fast", device="cpu")
    cfg = syn.tiny_config()
    frames = torch.from_numpy(_lane_frames(4))
    arts = t_step.front_artifacts_batch(frames, params, cfg,
                                        hoist_second_attempt=True)
    return params, cfg, arts


def _state(cfg, params, S=None, seed=0):
    """A state with every field set from ``seed`` (S streams, or one
    without the stream axis)."""
    st = t_step.make_initial_state(cfg, params.warped_size, "cpu")
    g = torch.Generator().manual_seed(seed)
    lead = () if S is None else (S,)
    out = []
    for x in st:
        shape = lead + tuple(x.shape)
        if x.dtype == torch.bool:
            out.append(torch.rand(shape, generator=g) > 0.5)
        elif x.dtype == torch.int32:
            out.append(torch.randint(-9, 9, shape, generator=g,
                                     dtype=torch.int32))
        else:
            out.append(torch.randn(shape, generator=g))
    return TrackerState(*out)


def test_layouts_follow_the_named_tuples():
    """The kernel's tables list the fields in the tuples' order."""
    assert tuple(bhk.STATE_LAYOUT) == TrackerState._fields
    assert tuple(bhk.OUT_LAYOUT) == t_step.StepOutput._fields[1:]
    assert tuple(bhk.META_LAYOUT) == t_step.RenderMeta._fields


@pytest.mark.parametrize("S", [1, 3])
def test_pack_state_round_trip(tiny, S):
    params, cfg, _ = tiny
    st = _state(cfg, params, S)
    packed = bhk.pack_state(st)
    assert len(packed) == len(TrackerState._fields)
    for x, orig in zip(packed, st):
        assert x.shape[0] == S and x.is_contiguous()
        assert x.dtype == (torch.uint8 if orig.dtype == torch.bool
                           else orig.dtype)
        assert x.data_ptr() == orig.data_ptr()  # a view, no copy
    back = bhk.unpack_state(packed)
    for name, a, b in zip(TrackerState._fields, back, st):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_pack_state_rejects_a_mistyped_or_misshapen_field(tiny):
    params, cfg, _ = tiny
    st = _state(cfg, params, 2)
    with pytest.raises(ValueError, match="counter"):
        bhk.pack_state(st._replace(counter=st.counter.long()))
    with pytest.raises(ValueError, match="radii"):
        bhk.pack_state(st._replace(radii=st.radii[:, :1]))


@pytest.mark.parametrize("case,eligible", [
    ("cond", False), ("hoist", True), ("one_attempt", True),
    ("one_attempt_hoisted", True)])
def test_dispatch_rule(tiny, case, eligible):
    """The kernel needs no host decision inside the scan: 'cond' with a
    second attempt and no attempt-2 artifacts never takes it; on the CPU
    nothing does."""
    params, cfg, arts = tiny
    if case.startswith("one_attempt"):
        cfg = cfg.replace(n_tries=1)
    if case in ("cond", "one_attempt"):
        arts = arts._replace(pref2=None, iv_sws2=None)
    assert bhk.kernel_eligible(arts, cfg) is eligible
    assert not bhk.takes_kernel(arts, cfg)


def test_cpu_schedules_take_the_twins(tiny, monkeypatch):
    """Every chunk schedule and a fleet step run on the CPU without
    reaching the kernel's wrapper."""
    params, cfg, _ = tiny

    def fail(*a, **k):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(bhk, "scan", fail)
    frames = _lane_frames(4)
    frames[2] = 0
    for mode in pipeline.MODES:
        chunk_process(t_step.make_initial_state(cfg, params.warped_size,
                                                "cpu"),
                      torch.from_numpy(frames), params, cfg,
                      with_overlay=False, second_attempt=mode)
    fleet = StreamFleet(params, cfg, 2, mesh=("cpu",),
                        second_attempt="hoist")
    fleet.step(np.stack([frames[:2], frames[2:]]))


def _kernel_inputs(tiny, S):
    params, cfg, arts = tiny
    arts = arts._replace(r_chan=None, b_chan=None)
    if S is None:
        return params, cfg, _state(cfg, params), arts
    arts = t_step.FrontArtifacts(*(
        None if x is None else
        (x.expand(S, *x.shape).contiguous() if isinstance(x, torch.Tensor)
         else type(x)(*(f.expand(S, *f.shape).contiguous() for f in x)))
        for x in arts))
    return params, cfg, _state(cfg, params, S), arts


@pytest.mark.parametrize("fault", [
    "non_contiguous_prefixes", "int64_prefixes", "int32_valid",
    "non_contiguous_state", "cond_without_attempt_2", "cpu"])
def test_scan_raises_before_any_launch(tiny, monkeypatch, fault):
    params, cfg, state, arts = _kernel_inputs(tiny, 1)

    def no_launch(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(bhk, "_launch", no_launch)
    packed = arts.pref.packed
    iv = arts.iv_sws
    match = {"non_contiguous_prefixes": "contiguous",
             "int64_prefixes": "prefixes", "int32_valid": "left_valid",
             "non_contiguous_state": "contiguous",
             "cond_without_attempt_2": "cond", "cpu": "device cpu"}[fault]
    if fault == "non_contiguous_prefixes":
        wide = torch.zeros(packed.shape[:-1] + (2 * packed.shape[-1],),
                           dtype=packed.dtype)
        arts = arts._replace(pref=arts.pref._replace(
            packed=wide[..., ::2]))
    elif fault == "int64_prefixes":
        arts = arts._replace(pref=arts.pref._replace(packed=packed.long()))
    elif fault == "int32_valid":
        arts = arts._replace(iv_sws=iv._replace(
            left_valid=iv.left_valid.int()))
    elif fault == "non_contiguous_state":
        wide = torch.zeros(1, state.rfitx_left.shape[1] * 2)
        state = state._replace(rfitx_left=wide[:, ::2])
    elif fault == "cond_without_attempt_2":
        arts = arts._replace(pref2=None, iv_sws2=None)
    with pytest.raises(ValueError, match=match):
        bhk.scan(state, arts, params, cfg)


@pytest.mark.parametrize("S,attempts", [(None, 1), (None, 2), (3, 2)])
def test_wrapper_with_a_stub_launch(tiny, monkeypatch, S, attempts):
    """With the launch stubbed: the tables hold the kernel's counts and a
    pointer for every tensor it reads or writes; the outputs have the
    twins' fields, types and shapes; the launch and S x T frames are
    counted.  One stream (S None) goes through ``scan_back_half``, which
    hands the kernel its state and artifacts as S = 1."""
    params, cfg, state, arts = _kernel_inputs(tiny, S)
    if attempts == 1:
        cfg = cfg.replace(n_tries=1)
        arts = arts._replace(pref2=None, iv_sws2=None)
    seen = {}

    def stub(device, ptrs, ints, floats):
        seen.update(ptrs=ptrs.copy(), ints=ints.copy(), floats=floats.copy())

    monkeypatch.setattr(bhk, "_launch", stub)
    monkeypatch.setattr(bhk, "_check_device", lambda device: None)
    monkeypatch.setattr(bhk, "takes_kernel", lambda arts, config: True)
    n0 = bhk.LAUNCHES["back_half"]
    with profiling.recording():
        if S is None:
            st, (outs, metas) = pipeline.scan_back_half(state, arts, params,
                                                        cfg)
        else:
            st, (outs, metas) = bhk.scan(state, arts, params, cfg)
    T = arts.pref.packed.shape[-3]
    assert bhk.LAUNCHES["back_half"] == n0 + 1
    want = {"lt.back_half.kernel_frames": (S or 1) * T}
    if S is None:
        want["lt.back_half.frames"] = T
    assert profiling.summary()["counters"] == want
    # csrc/back_half.cu's kPtrs: each attempt's prefixes and 10 interval
    # fields, the 2 sample grids, the state in and out, the outputs.
    n_attempt = 1 + len(bhk.ROW_FIELDS) + len(bhk.LEVEL_FIELDS)
    assert n_attempt == 11
    assert len(seen["ptrs"]) == 2 * n_attempt + 2 + 2 * 20 + 18 + 9
    assert (seen["ptrs"][n_attempt:2 * n_attempt] == 0).all() == (
        attempts == 1)
    assert (seen["ptrs"][2 * n_attempt:] != 0).all()
    assert seen["ints"][:2].tolist() == [S or 1, T]
    assert seen["ints"][9] == attempts
    # The twin's outputs on the same inputs: fields, types and shapes.
    if S is None:
        tw_st, (tw_outs, tw_metas) = scan_back_half_plain(state, arts,
                                                          params, cfg)
    else:
        tw_st, (tw_outs, tw_metas) = scan_streams_plain(state, arts, params,
                                                        cfg)
    for got, want in ((st, tw_st), (outs, tw_outs), (metas, tw_metas)):
        assert type(got) is type(want)
        for name, a, b in zip(got._fields, got, want):
            if b is None:
                assert a is None, name
                continue
            assert (a.dtype, a.shape) == (b.dtype, b.shape), name
            assert a.is_contiguous(), name


def _share_reader():
    path = ROOT / "benchmark" / "metrics" / "back_half_kernel_share.py"
    spec = importlib.util.spec_from_file_location("kernel_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("counters,share", [
    ({"lt.frames": 512, "lt.back_half.frames": 1024,
      "lt.back_half.kernel_frames": 1024}, 1.0),
    ({"lt.frames": 512, "lt.back_half.frames": 1024,
      "lt.back_half.kernel_frames": 512}, 0.5),
    ({"lt.frames": 512, "lt.back_half.frames": 1024}, None),
    ({"lt.frames": 512}, None),
    (None, None)])
def test_kernel_share_reader(counters, share):
    """``back_half_kernel_share``: kernel frames over back-half frames of
    the program stretch; nothing where either counter is missing (a
    program without the kernel) or the back half never ran."""
    mod = _share_reader()
    assert (mod.NAME, mod.UNIT, mod.SOURCE, mod.LAYER, mod.MOVES) == (
        "back_half_kernel_share", "share", "program_counter", "back half",
        "frames_per_s")
    reading = types.SimpleNamespace(program=None if counters is None else {
        "spans": {}, "counters": counters, "units": 1})
    assert mod.read(reading) == share


# ---- on the card ----

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from lane_tracker_tpu_torch.kernels.build import build

    path, seconds, _ = build()
    print(f"built {path.name} in {seconds:.1f} s")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def motion(card):
    """The three scenes on the card, for io.motion's frames."""
    from lane_tracker_tpu_torch.io.motion import load_scenes

    return load_scenes("cuda")


def _frames(scenes, ts):
    from lane_tracker_tpu_torch.io.motion import motion_frame

    return torch.stack([motion_frame(t, scenes) for t in ts])


# One stream: scene 0 with the black frames 450-455, then scene 1's end
# (attempt 1 fails there) into scene 2.  Sixteen streams: 32 frames from
# 140 + 20 i (scene 0 into 1, scene 1, scene 2, and 440-471 with the
# black frames).
ONE_STREAM = list(range(440, 472)) + list(range(285, 317))
FLEET_STARTS = [140 + 20 * i for i in range(16)]
PIPELINES = ("fast", "corridor", "compat", "turbo", "half")


@pytest.fixture(scope="module")
def card_params(card):
    from lane_tracker_tpu_torch import load_calibration_npz
    from lane_tracker_tpu_torch.tracker.config import PRESETS, halve_config

    cam, warp = load_calibration_npz(ROOT / "assets" / "calibration.npz")
    out = {}
    for name in PIPELINES:
        params = t_step.TrackerParams.build(
            cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph, pipeline=name)
        cfg = PRESETS["demo1"]
        out[name] = (params, halve_config(cfg) if name == "half" else cfg)
    return out


def _curve_gap(a, b, H):
    a = np.asarray(a.cpu(), np.float64).reshape(-1, 3)
    b = np.asarray(b.cpu(), np.float64).reshape(-1, 3)
    if not len(a):
        return 0.0
    y = np.arange(H, dtype=np.float64)
    d = a - b
    return float(np.abs(d[:, :1] * y * y + d[:, 1:2] * y + d[:, 2:3]).max())


def _artifacts(frames, params, cfg, batch=128):
    """Hoisted front artifacts of the frames, ``batch`` frames at a time
    (the front half's working set grows with its batch), without the
    channels."""
    parts = [t_step.front_artifacts_batch(frames[i:i + batch], params, cfg,
                                          hoist_second_attempt=True)
             ._replace(r_chan=None, b_chan=None)
             for i in range(0, len(frames), batch)]

    def cat(xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs)
        return type(xs[0])(*(cat(f) for f in zip(*xs)))

    return t_step.FrontArtifacts(*(cat(xs) for xs in zip(*parts)))


COEFF_OUT = ("left_coeffs", "right_coeffs", "a1_left_coeffs",
             "a1_right_coeffs")
COEFF_STATE = ("hist_left", "hist_right", "last_left", "last_right",
               "avg_left", "avg_right")


def _compare(kernel, twin, H) -> dict:
    """Every int and bool equal; the largest curve and graph gaps (px)
    and the shown radius's relative gap."""
    (k_st, (k_out, k_meta)), (t_st, (t_out, t_meta)) = kernel, twin
    for tup_k, tup_t in ((k_st, t_st), (k_out, t_out), (k_meta, t_meta)):
        for name, a, b in zip(tup_k._fields, tup_k, tup_t):
            if b is None or b.dtype.is_floating_point:
                continue
            assert torch.equal(a, b), (name, (a != b).nonzero()[:8])
    det = k_out.detected
    det1 = k_out.a1_detected
    gaps = [_curve_gap(getattr(k_out, n)[det if n[0] != "a" else det1],
                       getattr(t_out, n)[det if n[0] != "a" else det1], H)
            for n in COEFF_OUT]
    gaps += [_curve_gap(getattr(k_st, n), getattr(t_st, n), H)
             for n in COEFF_STATE]
    gaps += [_curve_gap(getattr(k_meta, n), getattr(t_meta, n), H)
             for n in ("coeffs_left", "coeffs_right")]
    graph = max(float((getattr(k, n) - getattr(t, n)).abs().max())
                for k, t in ((k_meta, t_meta), (k_st, t_st))
                for n in (("fitx_left", "fitx_right") if k is k_meta
                          else ("rfitx_left", "rfitx_right")))
    radius = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                 for a, b in ((k_out.radius, t_out.radius),
                              (k_st.radii, t_st.radii),
                              (k_st.avg_radius, t_st.avg_radius)))
    return {"curve_px": max(gaps), "graph_px": graph, "radius_rel": radius,
            "frames": int(k_out.valid.numel()),
            "valid": int(k_out.valid.sum()),
            "second": int((k_out.n_attempts > 1).sum()),
            "band": int(k_out.search_mode.sum()),
            "drawn_invalid": int((k_meta.draw & ~k_out.valid).sum())}


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 16])
@pytest.mark.parametrize("attempts", [1, 2])
@pytest.mark.parametrize("name", PIPELINES)
def test_kernel_equals_twin(card_params, motion, name, attempts, streams):
    params, cfg = card_params[name]
    if attempts == 1:
        cfg = cfg.replace(n_tries=1)
    H = params.warped_size[1]
    if streams == 1:
        frames = _frames(motion, ONE_STREAM)
    else:
        frames = _frames(motion, [t0 + k for t0 in FLEET_STARTS
                                  for k in range(32)])
    arts = _artifacts(frames, params, cfg)
    del frames
    state = t_step.make_initial_state(cfg, params.warped_size, "cuda")
    if streams == 1:
        kernel = pipeline.scan_back_half(state, arts, params, cfg)
        twin = scan_back_half_plain(state, arts, params, cfg)
    else:
        S, T = streams, 32
        arts = t_step.FrontArtifacts(*(
            None if x is None else
            (x.reshape(S, T, *x.shape[1:]) if isinstance(x, torch.Tensor)
             else type(x)(*(f.reshape(S, T, *f.shape[1:]) for f in x)))
            for x in arts))
        states = TrackerState(*(x.expand(S, *x.shape).contiguous()
                                for x in state))
        kernel = bhk.scan(states, arts, params, cfg)
        twin = scan_streams_plain(states, arts, params, cfg)
    torch.cuda.synchronize()
    got = _compare(kernel, twin, H)
    print(f"\n{name} attempts={attempts} S={streams}: {got}")
    assert got["curve_px"] <= CURVE_PX and got["graph_px"] <= CURVE_PX
    assert got["radius_rel"] <= RADIUS_REL
    # Failures, band and blind search, grace-period draws all occur.
    assert got["valid"] < got["frames"]
    assert 0 < got["band"] < got["frames"] and got["drawn_invalid"] > 0
    if attempts == 2:
        assert got["second"] > 0


@pytest.mark.cuda
def test_launches_counted_apart_from_the_filter_stage(card_params, motion):
    """One scan is one launch in the kernel's own counter and none in the
    filter stage's, which the benchmark's traced run holds to the trace's
    filter kernels; a two_phase chunk and a fleet step on the card count
    every back-half frame as a kernel frame."""
    from lane_tracker_tpu_torch.kernels.filter_stage import kernel_launches

    params, cfg = card_params["fast"]
    frames = _frames(motion, ONE_STREAM[:32])
    arts = t_step.front_artifacts_batch(frames, params, cfg,
                                        hoist_second_attempt=True)
    state = t_step.make_initial_state(cfg, params.warped_size, "cuda")
    torch.cuda.synchronize()
    f0, k0 = kernel_launches(), bhk.kernel_launches()
    pipeline.scan_back_half(state, arts, params, cfg)
    torch.cuda.synchronize()
    assert (kernel_launches() - f0, bhk.kernel_launches() - k0) == (0, 1)
    with profiling.recording():
        chunk_process(state, frames, params, cfg,
                      second_attempt="two_phase")
        fleet = StreamFleet(params, cfg, 2, mesh=["cuda"],
                            second_attempt="auto")
        fleet.step(frames.reshape(2, 16, *frames.shape[1:]))
    c = profiling.summary()["counters"]
    assert c["lt.back_half.kernel_frames"] == c["lt.back_half.frames"] > 0
