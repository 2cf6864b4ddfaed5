"""The port's multi-stream fleet against JAX's, and its own contracts.

The port's ``StreamFleet`` runs on a list of CPU devices
(``stream_mesh(devices=("cpu", "cpu"))``), JAX's on ``stream_mesh(2)``
over conftest's virtual CPU devices with the XLA filter chain
(``filter_backend="xla"``).

* Tiny geometry: each package's ``make_synthetic_calibration`` and
  ``tiny_config``, pipeline 'fast', the frames of tests/test_parallel.py's
  recipe, S=4 streams over 2 devices, T=2, two steps, stream 1 black in
  the first; in 'two_phase' and 'hoist'.
* Full size: demo1 'corridor' on assets/calibration.npz, S=2 over 2
  devices, T=4, stream s the four stills cycled from offset s, frame 0
  of stream 1 black (so two_phase's fallback fires), overlay on.

Tolerances: decision fields and integer state fields identical; every
coefficient (each frame's fit, and the state's history, last and smoothed
fits) within 0.01 px RMSE as a curve over the warped height; the state's
render graph (``rfitx_*``) within 0.01 px; overlays within 1 unit;
metrics identical.

The port's own contracts, mirrored from tests/test_parallel.py: states
advance per stream and live on each device of the list; streams are
independent; metrics equal per-stream ``chunk_process`` sums; 'auto'
flips at the crossover and back under hysteresis, on an any-over-shards
observable; an unknown schedule and streams that do not divide over the
devices raise; the default device list needs CUDA; ``stream_row_mesh``'s
shape and devices, and its default needs CUDA.  The batched back half
(``scan_streams``) equals a per-stream loop of ``scan_back_half`` exactly
on the CPU (the card may round a batched reduction differently in the
last bit; chip_smoke.py holds it there), and its operators per time step
do not grow with the streams.
"""

import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from tests.conftest import ASSETS_DIR
from tests.test_torch_pipeline import (
    DECISIONS,
    INT_STATE,
    curve_rmse,
    port_config,
)

import lane_tracker_tpu.calib.synthetic as j_syn
from lane_tracker_tpu.calib.io import load_calibration_npz as j_load
from lane_tracker_tpu.parallel.mesh import stream_mesh as j_stream_mesh
from lane_tracker_tpu.parallel.streams import StreamFleet as JFleet
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS

import lane_tracker_tpu_torch.calib.synthetic as t_syn
from lane_tracker_tpu_torch.calib.io import load_calibration_npz as t_load
from lane_tracker_tpu_torch.parallel import (
    StreamFleet,
    chunk_process,
    shard_streams,
    stream_mesh,
    stream_row_mesh,
)
from lane_tracker_tpu_torch.parallel.mesh import map_tensors, replicate
from lane_tracker_tpu_torch.parallel.pipeline import scan_back_half
from lane_tracker_tpu_torch.parallel.streams import (
    build_fleet_processor,
    scan_streams,
)
from lane_tracker_tpu_torch.tracker import step as t_step
from lane_tracker_tpu_torch.tracker.state import TrackerState

CPU2 = ("cpu", "cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The fleet's back half runs thousands of small operators; with the
    suite's workers sharing the cores, PyTorch's intra-op thread pool
    makes each cost far more than the work (a tiny step ran 10x slower
    under the suite than alone).  One thread for this module, restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
COEFF_STATE = ("hist_left", "hist_right", "last_left", "last_right",
               "avg_left", "avg_right")


def _lane_frames(n, H=96, W=128, seed=0):
    """tests/test_parallel.py's synthetic camera frames: two bright lane
    stripes converging toward the horizon over dark noise."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(20, 60, (n, H, W, 3), dtype=np.uint8)
    for t in range(n):
        for xfrac in (0.40, 0.60):
            for y in range(H // 2, H):
                depth = (y - H // 2) / (H / 2)
                x = int(W / 2 + (xfrac - 0.5) * W * depth)
                frames[t, y, max(x - 1, 0):min(x + 2, W), :] = 230
    return frames


def _fleet_frames(S, T, seed0=0):
    return np.stack([_lane_frames(T, seed=seed0 + s) for s in range(S)])


def _calib_args(cam, warp):
    return (cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
            warp.image_width_height, warp.warped_width_height, warp.mppv,
            warp.mpph)


PERMISSIVE = dict(min_dist_y1=0, max_dist_y1=10_000, min_dist_y2=0,
                  max_dist_y2=10_000, min_dist_y3=0, max_dist_y3=10_000,
                  tangent_thresh=1e9)


@pytest.fixture(scope="module")
def tiny_params():
    """(JAX params, port params) at the tiny geometry, 'fast'."""
    jp = j_step.TrackerParams.build(
        *_calib_args(*j_syn.make_synthetic_calibration()), pipeline="fast",
        filter_backend="xla")
    tp = t_step.TrackerParams.build(
        *_calib_args(*t_syn.make_synthetic_calibration()), pipeline="fast",
        device="cpu")
    return jp, tp


def _tiny_configs(validity):
    """(JAX config, port config): ``tiny_config``, under whose validity
    no tiny frame passes (every step takes the fallback), or with
    permissive validity (some steps keep attempt 1)."""
    jcfg, tcfg = j_syn.tiny_config(), t_syn.tiny_config()
    if validity == "permissive":
        jcfg = jcfg.replace(validity=type(jcfg.validity)(**PERMISSIVE))
        tcfg = tcfg.replace(validity=type(tcfg.validity)(**PERMISSIVE))
    return jcfg, tcfg


def _j_states(fleet):
    """JAX fleet states as one numpy array a field, (S, ...)."""
    return {f: np.asarray(getattr(fleet.states, f))
            for f in TrackerState._fields}


def _t_states(fleet):
    """The port's state shards joined into one (S, ...) array a field."""
    return {f: np.concatenate([getattr(s, f).numpy() for s in fleet.states])
            for f in TrackerState._fields}


def _assert_outs_match(jo, to, H, overlay=True):
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    for side in ("left_coeffs", "right_coeffs", "a1_left_coeffs",
                 "a1_right_coeffs"):
        a = getattr(to, side).numpy().reshape(-1, 3)
        b = np.asarray(getattr(jo, side)).reshape(-1, 3)
        assert max(curve_rmse(x, y, H) for x, y in zip(a, b)) <= 0.01, side
    if overlay:
        d = np.abs(to.overlay.numpy().astype(int)
                   - np.asarray(jo.overlay).astype(int))
        print(f"overlay: {int((d != 0).sum())} of {d.size} values differ")
        assert d.max() <= 1


def _assert_states_match(js, ts, H):
    for f in INT_STATE:
        np.testing.assert_array_equal(ts[f], js[f], err_msg=f)
    for f in COEFF_STATE:
        a, b = ts[f].reshape(-1, 3), js[f].reshape(-1, 3)
        assert max(curve_rmse(x, y, H) for x, y in zip(a, b)) <= 0.01, f
    for f in ("rfitx_left", "rfitx_right"):
        np.testing.assert_allclose(ts[f], js[f], rtol=0, atol=0.01,
                                   err_msg=f)


def _assert_metrics_match(jm, tm):
    assert {k: int(v) for k, v in tm.items()} == {
        k: int(v) for k, v in jm.items()}
    assert all(v.dtype == torch.int32 and v.dim() == 0 for v in tm.values())


@pytest.mark.parametrize("validity", ["tiny", "permissive"])
@pytest.mark.parametrize("schedule", ["two_phase", "hoist"])
def test_tiny_fleet_matches_jax(tiny_params, schedule, validity):
    """Steps of S=4 streams over 2 devices, T=2: stream 1 black in the
    first; with permissive validity a third in which stream 3's last
    frame is black, so one shard falls back and the other keeps attempt
    1.  Outputs, states after each step and metrics equal JAX's."""
    jp, tp = tiny_params
    jcfg, tcfg = _tiny_configs(validity)
    jf = JFleet(jp, jcfg, 4, mesh=j_stream_mesh(2), with_overlay=True,
                second_attempt=schedule)
    tf = StreamFleet(tp, tcfg, 4, mesh=CPU2, with_overlay=True,
                     second_attempt=schedule)
    H = tp.warped_size[1]
    steps = (0, 10, 20) if validity == "permissive" else (0, 10)
    for step, seed0 in enumerate(steps):
        frames = _fleet_frames(4, 2, seed0)
        if step == 0:
            frames[1] = 0
        if step == 2:
            frames[3, 1] = 0
        jo, jm = jf.step(frames)
        to, tm = tf.step(frames)
        assert to.valid.shape == (4, 2) and to.overlay.shape[:2] == (4, 2)
        _assert_outs_match(jo, to, H)
        _assert_states_match(_j_states(jf), _t_states(tf), H)
        _assert_metrics_match(jm, tm)
    a1 = to.a1_valid.numpy()
    if validity == "permissive":  # shard 0 kept, shard 1 fell back
        assert a1[:2].all() and not a1[2:].all()
    else:
        assert not a1.any()


def _stills_streams(S, T):
    """Stream s: the four stills cycled from offset s (fleet_bench's)."""
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        stills = z["frames"]
    return np.stack([stills[(s + np.arange(T)) % len(stills)]
                     for s in range(S)])


@pytest.fixture(scope="module")
def full():
    frames = _stills_streams(2, 4)
    frames[1, 0] = 0
    cfg = PRESETS["demo1"]
    jp = j_step.TrackerParams.build(
        *_calib_args(*j_load(ASSETS_DIR / "calibration.npz")),
        pipeline="corridor", filter_backend="xla")
    tp = t_step.TrackerParams.build(
        *_calib_args(*t_load(ASSETS_DIR / "calibration.npz")),
        pipeline="corridor", device="cpu")
    jf = JFleet(jp, cfg, 2, mesh=j_stream_mesh(2), with_overlay=True)
    tf = StreamFleet(tp, port_config(cfg), 2, mesh=CPU2, with_overlay=True)
    jo, jm = jf.step(frames)
    to, tm = tf.step(frames)
    return jp, (jf, jo, jm), (tf, to, tm)


def test_full_fleet_matches_jax(full):
    """demo1 'corridor', S=2 over 2 devices, T=4, stream 1's first frame
    black: two_phase's fallback fires on its shard; decisions, integer
    state and metrics identical, curves within 0.01 px, overlays within
    1 unit."""
    jp, (jf, jo, jm), (tf, to, tm) = full
    H = jp.warped_size[1]
    assert not bool(to.a1_valid[1, 0]) and int(tm["second_attempts"]) > 0
    _assert_outs_match(jo, to, H)
    _assert_states_match(_j_states(jf), _t_states(tf), H)
    _assert_metrics_match(jm, tm)


# ---- the port's own contracts (tests/test_parallel.py's, mirrored) ----


@pytest.fixture(scope="module")
def port_tiny(tiny_params):
    """Port params and the tiny config with a second attempt."""
    return tiny_params[1], _tiny_configs("tiny")[1]


def test_fleet_states_advance_per_stream_on_each_device(port_tiny):
    tp, cfg = port_tiny
    fleet = StreamFleet(tp, cfg, n_streams=4, mesh=CPU2)
    assert fleet.mesh == (torch.device("cpu"),) * 2
    assert len(fleet.params_device) == 2
    frames = _fleet_frames(4, 2)
    outs, metrics = fleet.step(frames)
    assert int(metrics["frames"]) == 8
    assert outs.valid.shape == (4, 2) and outs.overlay is None
    assert len(fleet.states) == 2
    for shard, dev in zip(fleet.states, fleet.mesh):
        assert shard.counter.shape == (2,)
        assert (shard.counter == 2).all()
        assert all(x.device == dev for x in shard)
    fleet.step(frames)
    assert all((s.counter == 4).all() for s in fleet.states)


def test_fleet_streams_independent(port_tiny):
    """A stream fed black frames fails while the others keep tracking."""
    tp, cfg = port_tiny
    fleet = StreamFleet(tp, cfg, n_streams=4, mesh=CPU2)
    frames = _fleet_frames(4, 2)
    frames[3] = 0
    outs, _ = fleet.step(frames)
    detected = outs.detected.numpy()
    assert not detected[3].any()
    assert detected[:3].any()


def test_fleet_metrics_equal_per_stream_chunk_sums(port_tiny):
    """The summed metrics over divergent shards equal the sums of
    per-stream ``chunk_process`` runs."""
    tp, cfg = port_tiny
    fleet = StreamFleet(tp, cfg, n_streams=4, mesh=CPU2)
    frames = _fleet_frames(4, 2)
    frames[2] = 0
    outs, metrics = fleet.step(frames)
    valid = detected = attempts2 = 0
    for s in range(4):
        _, o = chunk_process(
            t_step.make_initial_state(cfg, tp.warped_size, "cpu"),
            torch.from_numpy(frames[s]), tp, cfg, with_overlay=False,
            second_attempt="hoist")
        valid += int(o.valid.sum())
        detected += int(o.detected.sum())
        attempts2 += int((o.n_attempts > 1).sum())
    assert int(metrics["valid_frames"]) == valid
    assert int(metrics["detected_frames"]) == detected
    assert int(metrics["second_attempts"]) == attempts2
    assert int(metrics["frames"]) == 8


def test_fleet_auto_schedule_flips_at_crossover(port_tiny):
    """'auto': a sustained failure-dense load flips two_phase to hoist,
    outputs unchanged; clean observations flip it back below the
    crossover less the hysteresis."""
    tp, cfg = port_tiny
    fleet = StreamFleet(tp, cfg, n_streams=4, mesh=CPU2,
                        second_attempt="auto", auto_alpha=0.5)
    static = StreamFleet(tp, cfg, n_streams=4, mesh=CPU2,
                         second_attempt="two_phase")
    assert fleet.schedule == "two_phase" and fleet.poison_ema == 0.0
    black = np.zeros((4, 2) + tuple(tp.img_size[::-1]) + (3,), np.uint8)
    scheds = []
    for _ in range(3):  # EMA 0.5, 0.75, 0.875
        outs_a, _ = fleet.step(black)
        outs_s, _ = static.step(black)
        assert torch.equal(outs_a.valid, outs_s.valid)
        scheds.append(fleet.schedule)
    assert scheds == ["two_phase", "two_phase", "hoist"], scheds
    assert fleet.poison_ema > 0.81
    clean = types.SimpleNamespace(a1_valid=np.ones((4, 2), bool))
    for _ in range(6):
        fleet._auto_update(clean)
    assert fleet.schedule == "two_phase"
    assert fleet.poison_ema < 0.76


def test_fleet_auto_observable_is_any_over_shards(port_tiny):
    """One dead stream of four poisons every step and flips to hoist;
    failures in half the steps hold two_phase."""
    tp, cfg = port_tiny
    fleet = StreamFleet(tp, cfg, n_streams=4, mesh=CPU2,
                        second_attempt="auto", auto_alpha=0.5)
    a1_dead = np.ones((4, 2), bool)
    a1_dead[3] = False
    poisoned = types.SimpleNamespace(a1_valid=torch.from_numpy(a1_dead))
    for _ in range(3):
        fleet._auto_update(poisoned)
    assert fleet.schedule == "hoist" and fleet.poison_ema > 0.81
    clean = types.SimpleNamespace(a1_valid=torch.ones((4, 2), dtype=bool))
    for _ in range(4):
        fleet._auto_update(clean)
        fleet._auto_update(poisoned)
    assert fleet.schedule == "two_phase"
    assert 0.2 < fleet.poison_ema < 0.81


def test_fleet_rejects_unknown_schedule(port_tiny):
    tp, cfg = port_tiny
    with pytest.raises(ValueError, match="second_attempt"):
        StreamFleet(tp, cfg, n_streams=4, mesh=CPU2, second_attempt="typo")
    with pytest.raises(ValueError, match="second_attempt"):
        build_fleet_processor(cfg, (torch.device("cpu"),),
                              second_attempt="cond")


def test_fleet_rejects_streams_not_dividing(port_tiny):
    tp, cfg = port_tiny
    with pytest.raises(ValueError, match="divide"):
        StreamFleet(tp, cfg, n_streams=3, mesh=CPU2)
    with pytest.raises(ValueError, match="divide"):
        shard_streams(torch.zeros(3, 2), stream_mesh(devices=CPU2))


def test_fleet_default_devices_need_cuda(port_tiny, monkeypatch):
    """With no device list the fleet is on every CUDA device; without
    CUDA it raises and never carries on on the CPU."""
    tp, cfg = port_tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamFleet(tp, cfg, n_streams=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stream_mesh()


def test_stream_row_mesh_shape_and_devices():
    mesh = stream_row_mesh(2, 3, devices=["cpu"] * 7)
    assert len(mesh) == 2 and all(len(row) == 3 for row in mesh)
    assert all(d == torch.device("cpu") for row in mesh for d in row)
    assert stream_row_mesh(1, 2, devices=("cpu", "cpu")) == (
        (torch.device("cpu"), torch.device("cpu")),)
    with pytest.raises(ValueError, match="needs 4 devices"):
        stream_row_mesh(2, 2, devices=("cpu",) * 3)


def test_stream_row_mesh_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stream_row_mesh(1, 2)


def _streams_arts(tp, cfg, S, T, hoist):
    frames = _fleet_frames(S, T)
    frames[1, 0] = 0
    arts = t_step.front_artifacts_batch(
        torch.from_numpy(frames.reshape((S * T,) + frames.shape[2:])), tp,
        cfg, hoist_second_attempt=hoist)
    return map_tensors(lambda x: x.reshape((S, T) + x.shape[1:]), arts)


@pytest.mark.parametrize("hoist", [False, True])
def test_batched_back_half_equals_per_stream_scans(port_tiny, hoist):
    """``scan_streams`` over S=3 streams equals ``scan_back_half`` of each
    stream on its own, exactly (the CPU's batched reductions give the
    same bits); with hoisted attempt-2 artifacts and, without them, at
    one attempt (two_phase's first scan)."""
    tp, cfg = port_tiny
    if not hoist:
        cfg = cfg.replace(n_tries=1)
    S, T = 3, 3
    arts = _streams_arts(tp, cfg, S, T, hoist)
    state0 = t_step.make_initial_state(cfg, tp.warped_size, "cpu")
    states = TrackerState(*(x.expand(S, *x.shape).contiguous()
                            for x in state0))
    st_b, (outs_b, metas_b) = scan_streams(states, arts, tp, cfg)
    for s in range(S):
        st, (outs, metas) = scan_back_half(
            state0, map_tensors(lambda x: x[s], arts), tp, cfg)
        for name, a in st._asdict().items():
            assert torch.equal(a, getattr(st_b, name)[s]), name
        for name, a in outs._asdict().items():
            if a is not None:
                assert torch.equal(a, getattr(outs_b, name)[s]), name
        for name, a in metas._asdict().items():
            assert torch.equal(a, getattr(metas_b, name)[s]), name
    assert not bool(outs_b.a1_valid[1, 0])


class _OpCount(TorchDispatchMode):
    """Counts the operators that run below vmap's batching (each one
    kernel launch on the card), views aside."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_batched_back_half_operators_do_not_grow_with_streams(port_tiny):
    """A time step of ``scan_streams`` runs the same operators at S=1 and
    S=4 (two_phase's first scan, and with hoisted artifacts)."""
    tp, cfg = port_tiny
    counts = {}
    for hoist in (False, True):
        c = cfg if hoist else cfg.replace(n_tries=1)
        for S in (1, 4):
            arts = map_tensors(lambda x: x[:S],
                               _streams_arts(tp, c, max(S, 2), 1, hoist))
            state0 = t_step.make_initial_state(c, tp.warped_size, "cpu")
            states = TrackerState(*(x.expand(S, *x.shape).contiguous()
                                    for x in state0))
            with _OpCount() as count:
                scan_streams(states, arts, tp, c)
            counts[hoist, S] = count.n
    print(counts)
    for hoist in (False, True):
        assert counts[hoist, 4] == counts[hoist, 1] > 100


def test_replicate_builds_params_per_device(port_tiny):
    """``replicate`` keeps params already on a device and copies every
    buffer for another (here PyTorch's ``meta`` device), the geometry
    shared; ``copy_to`` gives equal buffers in new storage."""
    tp, _ = port_tiny
    same, meta = replicate(tp, stream_mesh(devices=("cpu", "meta")))
    assert same is tp
    names = [n for n, _ in tp.named_buffers()]
    assert names == [n for n, _ in meta.named_buffers()]
    assert all(b.device.type == "meta" for b in meta.buffers())
    assert (meta.warped_size, meta.raw_roi, meta.pipeline) == (
        tp.warped_size, tp.raw_roi, tp.pipeline)
    copy = tp.copy_to("cpu")
    for (n, a), b in zip(tp.named_buffers(), copy.buffers()):
        assert torch.equal(a, b), n
        assert a.numel() == 0 or a.data_ptr() != b.data_ptr(), n
    assert copy.grid_warp_roi.dst_shape == tp.grid_warp_roi.dst_shape
