"""The port's own spans and counters (``utils/profiling.py``).

On the CPU at the tiny geometry (the port's synthetic 128x96 calibration,
``tiny_config``, 'fast', T=4; the fleet on ``CPU2``, two shards of two
streams): with tracing off ``span`` is one shared no-op that enters no
``record_function`` and counters stay still; inside ``recording()`` a
two_phase chunk counts its scans, rescans and host reads exactly, its
spans nest inside their parents, and a fleet step counts S x T frames a
scan, with the back half's sub-spans opened under ``torch.func.vmap``;
under ``torch.profiler`` every ``lt.back_half.*`` range lies inside an
``lt.back_half`` range.  On 'corridor' (``TINY_CORRIDOR``) each attempt's
embedding opens ``lt.corridor.embed`` under its stage and
``process_chunk`` counts the corridor's frames on its one flags read;
'fast' opens and counts none of it.

Four tests are marked ``cuda`` and skip without a card: on the card,
under ``torch.cuda.set_sync_debug_mode("warn")``, every synchronising
call of ``LaneTracker.process_chunk`` ('fast' and 'corridor') is a
counted ``lt.host_read`` (its frames stream up in pinned slices, one
``lt.upload`` range a slice, with no synchronising call) and every one
of ``StreamFleet.step`` a counted read or its one ``lt.upload`` copy, and
'corridor''s certified frames decide as full-width 'fast''s do; under
``torch.profiler`` the ``lt.back_half.*`` ranges of a 'cond' chunk's
per-frame loop and the launches of the back-half kernel lie inside
``lt.back_half`` ranges, and each ``lt.upload`` range holds the launch
of one host-to-card copy of frames; on a motion chunk with a dropout the
streamed chunk equals the whole-tensor path bit for bit, its frame
copies are pinned, on a stream of their own, overlap the warp, and a
second chunk allocates no pinned memory.  This file
imports no jax; run those tests on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_telemetry.py -q
"""

import contextlib
import json
import pathlib
import warnings

import numpy as np
import pytest
import torch

from lane_tracker_tpu_torch import LaneTracker
from lane_tracker_tpu_torch.calib import synthetic as syn
from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
from lane_tracker_tpu_torch.parallel.streams import StreamFleet
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.tracker import tracker as t_tracker
from lane_tracker_tpu_torch.tracker import upload
from lane_tracker_tpu_torch.utils import profiling

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
CPU2 = ("cpu", "cpu")
T = 4
PERMISSIVE = dict(min_dist_y1=0, max_dist_y1=10_000, min_dist_y2=0,
                  max_dist_y2=10_000, min_dist_y3=0, max_dist_y3=10_000,
                  tangent_thresh=1e9)
PARTS = ("lt.back_half.attempt", "lt.back_half.update", "lt.back_half.stack")
# 'corridor' at the tiny geometry (96 warped columns): the middle half,
# computed with the margin over the whole width.
TINY_CORRIDOR = (24, 72)
CORRIDOR_COUNTERS = ("lt.corridor.frames", "lt.corridor.uncertified")
# The card tests' chunk of eight stills streams up in slices of three
# frames: three slices, the last short.
CARD_SLICE = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The back half's many small operators: one intra-op thread under
    the suite's workers, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lane_frames(n, H=96, W=128, seed=0):
    """Two bright lane stripes converging toward the horizon over dark
    noise (tests/test_torch_fleet.py's frames)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(20, 60, (n, H, W, 3), dtype=np.uint8)
    for t in range(n):
        for xfrac in (0.40, 0.60):
            for y in range(H // 2, H):
                depth = (y - H // 2) / (H / 2)
                x = int(W / 2 + (xfrac - 0.5) * W * depth)
                frames[t, y, max(x - 1, 0):min(x + 2, W), :] = 230
    return frames


def _calib_args():
    cam, warp = syn.make_synthetic_calibration()
    return (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)


def _tiny(pipeline):
    """``tiny``'s (params, config, state) on ``pipeline``."""
    kw = {"col_roi": TINY_CORRIDOR} if pipeline == "corridor" else {}
    params = t_step.TrackerParams.build(*_calib_args(), pipeline=pipeline,
                                        device="cpu", **kw)
    cfg = syn.tiny_config()
    cfg = cfg.replace(validity=type(cfg.validity)(**PERMISSIVE))
    state, _ = chunk_process(
        t_step.make_initial_state(cfg, params.warped_size, "cpu"),
        torch.from_numpy(_lane_frames(T)), params, cfg,
        second_attempt="two_phase")
    return params, cfg, state


@pytest.fixture(scope="module")
def tiny():
    """(params, permissive config, a state one chunk in): from it, a chunk
    of lane frames passes attempt 1 on every frame, and a black frame
    fails it."""
    return _tiny("fast")


@pytest.fixture(scope="module")
def tinies(tiny):
    """``tiny`` by pipeline: 'fast' and 'corridor' (``TINY_CORRIDOR``)."""
    return {"fast": tiny, "corridor": _tiny("corridor")}


def _chunk(tiny, failing: bool):
    params, cfg, state = tiny
    frames = _lane_frames(T, seed=1)
    if failing:
        frames[2] = 0
    _, outs = chunk_process(state, torch.from_numpy(frames), params, cfg,
                            second_attempt="two_phase")
    assert bool(outs.a1_valid.all()) != failing
    return outs


def test_span_with_tracing_off_is_the_shared_noop(tiny, monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(profiling, "record_function", entered)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("lt.a") is profiling.span("lt.b")
    assert profiling.unit("lt.chunk", T) is profiling.span("lt.a")
    with profiling.recording():
        pass
    before = profiling.summary()
    _chunk(tiny, failing=True)
    profiling.count("lt.frames", 5)
    assert profiling.summary() == before == {"spans": {}, "counters": {},
                                             "units": 0}


@pytest.mark.parametrize("failing", [False, True])
def test_two_phase_chunk_counts_scans_rescans_and_reads(tiny, failing):
    with profiling.recording():
        _chunk(tiny, failing)
    s = profiling.summary()
    assert s["units"] == 1
    assert s["counters"] == {
        "lt.frames": T, "lt.back_half.frames": 2 * T if failing else T,
        "lt.host_reads": 1, **({"lt.rescans": 1} if failing else {})}
    assert s["spans"]["lt.chunk"]["n"] == 1
    assert s["spans"]["lt.back_half"]["n"] == (2 if failing else 1)
    assert s["spans"]["lt.host_read"]["n"] == 1
    assert s["spans"]["lt.back_half.update"]["n"] == s["counters"][
        "lt.back_half.frames"]


def test_spans_nest_inside_their_parents(tiny):
    """A failing chunk: attempt spans T under the first scan, then 2T
    under the rescan (both attempts a frame); each child inside its
    parent in time and unit, every self time at least 0."""
    with profiling.recording():
        _chunk(tiny, failing=True)
    spans = profiling.spans()
    scans = [i for i, s in enumerate(spans) if s["name"] == "lt.back_half"]
    attempts = [sum(s["name"] == "lt.back_half.attempt"
                    and s["parent"] == i for s in spans) for i in scans]
    assert attempts == [T, 2 * T]
    for s in spans:
        assert s["end_ns"] >= s["start_ns"] > 0
        if s["parent"] < 0:
            assert s["name"] == "lt.chunk" and s["unit"] == 0
            continue
        p = spans[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        assert p["unit"] == s["unit"]
        if s["name"] in PARTS:
            assert p["name"] == "lt.back_half"
    for name, row in profiling.summary()["spans"].items():
        assert 0 <= row["self_ns"] <= row["total_ns"], name


def test_fleet_steps_count_streams_times_frames_a_scan(tiny):
    """'auto' on CPU2 (4 streams, T frames): the first step fails on every
    frame (``tiny_config``'s validity), so each shard rescans and the
    schedule flips to hoist; the second step runs hoisted, one scan.  The
    back half's sub-spans open under vmap, once a time step a shard."""
    params = tiny[0]
    fleet = StreamFleet(params, syn.tiny_config(), 4, mesh=CPU2,
                        second_attempt="auto", auto_alpha=1.0)
    frames = np.stack([_lane_frames(T, seed=s) for s in range(4)])
    with profiling.recording():
        fleet.step(frames)
    s = profiling.summary()
    assert fleet.schedule == "hoist"
    assert s["units"] == 1 and s["spans"]["lt.fleet_step"]["n"] == 1
    assert s["counters"] == {"lt.frames": 4 * T,
                             "lt.back_half.frames": 2 * 4 * T,
                             "lt.rescans": 2, "lt.host_reads": 2 + 1,
                             "lt.fleet.schedule_flips": 1}
    spans = s["spans"]
    assert spans["lt.upload"]["n"] == 1
    assert spans["lt.back_half.attempt"]["n"] == 2 * T + 2 * 2 * T
    assert spans["lt.back_half.update"]["n"] == 2 * T + 2 * T
    assert spans["lt.back_half.stack"]["n"] == 4
    with profiling.recording():
        fleet.step(frames)
    s = profiling.summary()
    assert s["counters"] == {"lt.frames": 4 * T,
                             "lt.back_half.frames": 4 * T,
                             "lt.host_reads": 1, "lt.fleet.hoist_steps": 1}
    assert s["spans"]["lt.back_half.attempt"]["n"] == 2 * 2 * T


def test_process_chunk_is_one_unit_with_its_upload(tiny):
    """``LaneTracker.process_chunk``: the root ``lt.chunk`` holds the
    upload (on the CPU one plain copy, one ``lt.upload`` range) and
    ``chunk_process``, which opens no root of its own; two host reads
    (two_phase's and the valid flags for the success count)."""
    a = _calib_args()
    tracker = LaneTracker(a[4], a[5], a[0], a[1], a[2:4], a[6:],
                          device="cpu")
    frames = _lane_frames(T)
    with profiling.recording():
        tracker.process_chunk(frames, with_overlay=False)
    s = profiling.summary()
    assert s["units"] == 1
    assert s["spans"]["lt.chunk"]["n"] == 1
    assert s["spans"]["lt.upload"]["n"] == 1
    assert s["counters"]["lt.frames"] == T
    assert s["counters"]["lt.host_reads"] == 2
    roots = [x for x in profiling.spans() if x["parent"] < 0]
    assert [x["name"] for x in roots] == ["lt.chunk"]


def test_profiler_ranges_nest_inside_the_back_half(tiny, tmp_path):
    """Under a CPU ``torch.profiler`` the spans are ``record_function``
    ranges: every ``lt.back_half.*`` range lies inside an
    ``lt.back_half`` range, the fleet's under vmap too."""
    params = tiny[0]
    fleet = StreamFleet(params, syn.tiny_config(), 4, mesh=CPU2)
    frames = np.stack([_lane_frames(T, seed=s) for s in range(4)])
    with profiling.maybe_profile(tmp_path):
        _chunk(tiny, failing=True)
        fleet.step(frames)
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in events}
    assert {"lt.chunk", "lt.fleet_step", "lt.upload", "lt.host_read",
            *PARTS} <= names
    halves = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] == "lt.back_half"]
    parts = [e for e in events if e["name"] in PARTS]
    assert len(parts) >= 2 * T
    for e in parts:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                   for a, b in halves), e


@pytest.mark.parametrize("failing", [False, True])
@pytest.mark.parametrize("pipeline", ["fast", "corridor"])
def test_corridor_embed_spans_nest_in_each_attempts_stage(tinies, pipeline,
                                                          failing):
    """On 'corridor' each attempt's embedding opens one
    ``lt.corridor.embed`` span, under ``lt.embed_search`` (attempt 1) or
    ``lt.second_attempt`` (two_phase's rescan), inside it in time;
    'fast' opens none.  ``chunk_process`` alone counts no corridor frames
    (``process_chunk`` does)."""
    with profiling.recording():
        _chunk(tinies[pipeline], failing)
    spans = profiling.spans()
    embeds = [x for x in spans if x["name"] == "lt.corridor.embed"]
    parents = [spans[x["parent"]] for x in embeds]
    want = ["lt.embed_search"] + (["lt.second_attempt"] if failing else [])
    assert [p["name"] for p in parents] == (
        want if pipeline == "corridor" else [])
    for x, p in zip(embeds, parents):
        assert p["start_ns"] <= x["start_ns"] <= x["end_ns"] <= p["end_ns"]
    assert not set(CORRIDOR_COUNTERS) & set(profiling.summary()["counters"])


@pytest.mark.parametrize("pipeline", ["fast", "corridor"])
def test_process_chunk_counts_the_corridor_on_its_one_read(tinies, pipeline):
    """``process_chunk`` on a chunk with a black frame: two host reads, as
    on 'fast' (two_phase's and the flags'); on 'corridor' the flags' read
    carries the certificate, counted as the chunk's frames and those it
    does not certify (``process``'s search settings read outside
    ``TINY_CORRIDOR``); 'fast' counts neither and opens no embed span."""
    a = _calib_args()
    tracker = LaneTracker(a[4], a[5], a[0], a[1], a[2:4], a[6:],
                          device="cpu")
    # LaneTracker's own corridor, (320, 832), lies outside the tiny
    # geometry's 96 warped columns.
    tracker.params = tinies[pipeline][0]
    frames = _lane_frames(T, seed=1)
    frames[2] = 0
    with profiling.recording():
        outs = tracker.process_chunk(frames, with_overlay=False)
    s = profiling.summary()
    assert s["counters"]["lt.host_reads"] == 2
    assert s["counters"]["lt.rescans"] == 1
    assert s["spans"]["lt.host_read"]["n"] == 2
    counted = {k: v for k, v in s["counters"].items()
               if k in CORRIDOR_COUNTERS}
    assert tracker.success == int(outs.valid.sum())
    if pipeline == "fast":
        assert counted == {} and "lt.corridor.embed" not in s["spans"]
        return
    uncertified = int((~outs.corridor_ok).sum())
    assert uncertified > 0
    assert counted == {"lt.corridor.frames": T,
                       "lt.corridor.uncertified": uncertified}
    assert s["spans"]["lt.corridor.embed"]["n"] == 2


@pytest.fixture(scope="module")
def card_inputs():
    """On the card: demo1's params ('fast') and the eight stills with a
    black frame (frame 5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from lane_tracker_tpu_torch import load_calibration_npz
    from lane_tracker_tpu_torch.kernels.build import build

    build()
    cam, warp = load_calibration_npz(ASSETS / "calibration.npz")
    args = (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)
    with np.load(ASSETS / "stills_720p.npz") as z:
        stills = z["frames"][np.arange(8) % 4]
    stills[5] = 0
    return args, stills


@contextlib.contextmanager
def _slices_of(frames: int, frame: np.ndarray):
    """``upload.SLICE_BYTES`` at ``frames`` frames like ``frame`` inside
    the block."""
    keep = upload.SLICE_BYTES
    upload.SLICE_BYTES = frames * frame.nbytes
    try:
        yield
    finally:
        upload.SLICE_BYTES = keep


@pytest.fixture(scope="module")
def card_calls(card_inputs):
    """On the card: ``process_chunk`` and an 'auto' fleet step (two
    streams of four) on the stills with a black frame, so two_phase
    rescans and 'auto' reads its observation; each called once to warm
    up."""
    from lane_tracker_tpu_torch.tracker.config import PRESETS

    args, stills = card_inputs
    tracker = LaneTracker(args[4], args[5], args[0], args[1], args[2:4],
                          args[6:])
    params = t_step.TrackerParams.build(*args, pipeline="fast")
    fleet = StreamFleet(params, PRESETS["demo1"], 2,
                        mesh=["cuda"], with_overlay=True,
                        second_attempt="auto")
    fleet_frames = stills.reshape((2, 4) + stills.shape[1:])

    def chunk():
        with _slices_of(CARD_SLICE, stills[0]):
            return tracker.process_chunk(stills)

    calls = {"process_chunk": chunk,
             "StreamFleet.step": lambda: fleet.step(fleet_frames)}
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    return calls


@pytest.fixture(scope="module")
def twin_call(card_inputs):
    """On the card: a 'cond' ``chunk_process`` (demo1, 'fast', the frames
    already on the card) on the same stills.  'cond' reads attempt 1's
    validity on the host every frame, so it keeps the per-frame loop,
    whose parts open the ``lt.back_half.*`` ranges; called once to warm
    up."""
    from lane_tracker_tpu_torch.tracker.config import PRESETS

    args, stills = card_inputs
    cfg = PRESETS["demo1"]
    params = t_step.TrackerParams.build(*args, pipeline="fast")
    frames = torch.from_numpy(stills).cuda()

    def call():
        state = t_step.make_initial_state(cfg, params.warped_size, "cuda")
        return chunk_process(state, frames, params, cfg,
                             second_attempt="cond")

    call()
    torch.cuda.synchronize()
    return call


@pytest.mark.cuda
def test_every_sync_on_the_card_is_a_counted_read_or_the_upload(card_calls):
    """Counted under the sync debug mode.  ``process_chunk``'s frames
    stream up in pinned slices, one ``lt.upload`` range a slice, with no
    synchronising call, so its every sync is a counted read; the fleet
    step's one upload is a synchronising copy."""
    for name, call in card_calls.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with profiling.recording():
                    call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = [str(w.message) for w in caught if str(w.message)
                 .startswith("called a synchronizing CUDA operation")]
        s = profiling.summary()
        reads = s["counters"].get("lt.host_reads", 0)
        uploads = s["spans"]["lt.upload"]["n"]
        streamed = s["counters"].get("lt.upload.streamed_frames", 0)
        print(f"{name}: {len(syncs)} synchronising calls, {reads} host "
              f"reads, {uploads} upload ranges, {streamed} frames "
              f"streamed")
        assert reads >= 1, name
        if name == "process_chunk":
            assert uploads == -(-8 // CARD_SLICE) and streamed == 8
            assert len(syncs) == reads, (name, syncs)
        else:
            assert uploads == 1 and streamed == 0, name
            assert len(syncs) == reads + uploads, (name, syncs)


@pytest.mark.cuda
def test_corridor_on_the_card(card_inputs):
    """'corridor''s ``process_chunk`` on the card, under the sync debug
    mode: every synchronising call is a counted read, two reads as on
    'fast' (the frames stream up in pinned slices with none), the
    corridor's frames counted.  And the
    certificate's promise: from the same fresh state on the same frames,
    up to the first frame it does not certify, every decision equals
    full-width 'fast''s."""
    from lane_tracker_tpu_torch.tracker.config import PRESETS

    args, stills = card_inputs
    tracker = LaneTracker(args[4], args[5], args[0], args[1], args[2:4],
                          args[6:], pipeline="corridor")
    with _slices_of(CARD_SLICE, stills[0]):
        tracker.process_chunk(stills)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with profiling.recording():
                    outs = tracker.process_chunk(stills)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught if str(w.message)
             .startswith("called a synchronizing CUDA operation")]
    s = profiling.summary()
    print(f"corridor: {len(syncs)} synchronising calls, counters "
          f"{s['counters']}")
    assert s["counters"]["lt.host_reads"] == 2
    assert s["spans"]["lt.upload"]["n"] == -(-len(stills) // CARD_SLICE)
    assert s["counters"]["lt.upload.streamed_frames"] == len(stills)
    assert len(syncs) == 2, syncs
    assert s["counters"]["lt.corridor.frames"] == len(stills)
    assert s["counters"]["lt.corridor.uncertified"] == int(
        (~outs.corridor_ok).sum())
    assert s["spans"]["lt.corridor.embed"]["n"] == 2

    cfg = PRESETS["demo1"]
    frames = torch.from_numpy(stills).cuda()
    decided = {}
    for pipeline in ("fast", "corridor"):
        params = t_step.TrackerParams.build(*args, pipeline=pipeline)
        state = t_step.make_initial_state(cfg, params.warped_size, "cuda")
        _, o = chunk_process(state, frames, params, cfg,
                             second_attempt="two_phase")
        decided[pipeline] = {k: v.cpu().numpy()
                             for k, v in o._asdict().items()
                             if v is not None}
    ok = decided["corridor"]["corridor_ok"]
    upto = len(ok) if ok.all() else int(np.argmin(ok))
    print(f"corridor_ok {ok.tolist()}: decisions compared on frames "
          f"[0, {upto})")
    assert upto >= 1
    for k in ("valid", "detected", "a1_valid", "a1_detected", "n_attempts",
              "search_mode", "render_mode"):
        assert np.array_equal(decided["fast"][k][:upto],
                              decided["corridor"][k][:upto]), k


@pytest.mark.cuda
def test_profiled_ranges_on_the_card(card_calls, twin_call, tmp_path):
    """Under ``torch.profiler`` on the card, in the device trace's clock:
    every ``lt.back_half.*`` range lies inside an ``lt.back_half`` range
    (the 'cond' chunk's per-frame loop opens them; the two calls that
    scan by the back-half kernel open none), every launch of the
    back-half kernel lies inside one, and each ``lt.upload`` range holds
    the launch of one host-to-card copy of frames (a slice of the
    chunk's, three slices; the fleet step's whole)."""
    with profiling.maybe_profile(tmp_path):
        for call in card_calls.values():
            call()
        twin_call()
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    halves = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
              if e["name"] == "lt.back_half"]
    parts = [e for e in ranges if e["name"] in PARTS]
    assert len(parts) >= 8
    for e in parts:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                   for a, b in halves), e
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    scans = [launched_at.get(e.get("args", {}).get("correlation"))
             for e in events if e.get("cat") == "kernel"
             and "back_half_scan_kernel" in e.get("name", "")]
    # process_chunk's two scans (the black frame makes two_phase rescan)
    # and the fleet step's one or two.
    assert len(scans) >= 3
    for ts in scans:
        assert ts is not None and any(a <= ts <= b for a, b in halves)
    copies = [launched_at.get(e.get("args", {}).get("correlation"))
              for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    uploads = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
               if e["name"] == "lt.upload"]
    print(f"{len(uploads)} lt.upload ranges, {len(copies)} frame copies")
    assert len(uploads) == -(-8 // CARD_SLICE) + 1
    for a, b in uploads:
        assert sum(ts is not None and a <= ts <= b for ts in copies) == 1


@pytest.mark.cuda
def test_streamed_chunk_on_the_card(card_inputs, tmp_path, monkeypatch):
    """``process_chunk`` on host frames of the motion sequence, 384-511
    (black at 450-455, so two_phase rescans), at the module's slice size:
    from the same start state it equals ``chunk_process`` given the frames
    as one tensor on the card, bit for bit, every field and the end
    state.  Under ``torch.profiler``, on the second chunk: every
    host-to-card copy of frames is pinned and on a stream that runs no
    warp kernel, they carry the chunk's bytes, one copy an ``lt.upload``
    range, at least one overlaps a warp kernel, no pageable host-to-card
    copy runs, and no pinned memory is allocated."""
    from lane_tracker_tpu_torch.io.motion import load_scenes, motion_frame

    args, _ = card_inputs
    scenes = load_scenes("cuda")
    frames = torch.stack([motion_frame(t, scenes)
                          for t in range(384, 512)]).cpu().numpy()
    del scenes
    bounds = upload.slice_frames(frames[0].nbytes)
    n_slices = -(-len(frames) // bounds)
    assert n_slices >= 3
    built = []
    build = t_tracker.build_chunk_processor

    def spy(config, **kw):
        built.append((config, kw))
        return build(config, **kw)

    monkeypatch.setattr(t_tracker, "build_chunk_processor", spy)
    tracker = LaneTracker(args[4], args[5], args[0], args[1], args[2:4],
                          args[6:])
    tracker.process_chunk(frames)
    pinned = [b.data_ptr() for b in tracker._staging.buffers]
    torch.cuda.synchronize()
    with profiling.maybe_profile(tmp_path), profiling.recording():
        outs = tracker.process_chunk(frames)
        torch.cuda.synchronize()
    s = profiling.summary()
    assert s["counters"]["lt.upload.streamed_frames"] == len(frames)
    assert s["counters"]["lt.rescans"] == 1
    assert s["spans"]["lt.upload"]["n"] == n_slices
    assert s["spans"]["lt.warp_lab"]["n"] == n_slices
    assert [b.data_ptr() for b in tracker._staging.buffers] == pinned

    config, kw = built[-1]
    state, want = chunk_process(tracker._prev_state,
                                torch.from_numpy(frames).cuda(),
                                tracker.params, config, **kw)
    for f in want._fields:
        w, g = getattr(want, f), getattr(outs, f)
        assert (w is None) == (g is None), f
        if w is not None:
            assert torch.equal(g, w), f
    for f in state._fields:
        assert torch.equal(getattr(tracker._state, f), getattr(state, f)), f

    events = json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ranges = [e for e in events if e.get("cat") == "user_annotation"]

    def inside(name):
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
                 if e["name"] == name]

        def test(ev):
            launch = launches.get(ev.get("args", {}).get("correlation"))
            return launch is not None and any(
                a <= launch["ts"] <= b for a, b in spans)
        return test

    in_warp, in_upload = inside("lt.warp_lab"), inside("lt.upload")
    warps = [e for e in events if e.get("cat") == "kernel" and in_warp(e)]
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e["name"]]
    copies = [e for e in h2d if in_upload(e)]
    print(f"{len(warps)} warp kernels, {len(copies)} frame copies: "
          f"{sorted({e['name'] for e in h2d})}")
    assert warps and len(copies) == n_slices
    assert sum(e["args"]["bytes"] for e in copies) == frames.nbytes
    assert all("Pinned" in e["name"] for e in copies)
    assert not [e for e in h2d if "Pageable" in e["name"]]
    warp_streams = {e["args"]["stream"] for e in warps}
    assert not warp_streams & {e["args"]["stream"] for e in copies}
    assert any(c["ts"] < w["ts"] + w["dur"] and w["ts"] < c["ts"] + c["dur"]
               for c in copies for w in warps)
    assert not [e for e in events if e.get("cat") in ("cuda_runtime",
                                                      "cuda_driver")
                and ("HostAlloc" in e.get("name", "")
                     or "HostRegister" in e.get("name", ""))]
