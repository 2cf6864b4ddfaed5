"""The port's measuring entry points against the JAX system, on the CPU.

``bench_torch.run`` (the port of bench.py's ``_run``) at T=8 on the bench's
three chunks: the four stills cycled, the same with every 16th frame black
(frame 0, so two_phase's fallback runs), and the motion frames
(``io.motion.motion_chunk``; tests/test_torch_motion.py holds them to the
cv2 generator's).  JAX's ``chunk_process`` (demo1 'corridor', two_phase,
overlay on, its XLA filter chain, fresh state) runs on the same frames,
once for the module.  The port's first chunk, read through a recording
``build_chunk_processor``, must give JAX's validity trace and the oracle's
prefix, its curves must be within the fit contract of 0.01 px RMSE of
JAX's, and the line's ``rmse_px_max`` within 0.01 px of bench.py's formula
(bench.py:257-269, written out here) on JAX's coefficients.

The gates are live: a forced-false certificate reruns the default in
'fast' and says so, and raises under an explicit 'corridor'; an oracle
copy with one validity bit flipped, or one curve moved by 1 px, makes the
run raise; a missing committed oracle raises, and a fail-k with no oracle
reports a null RMSE.  The entry points raise without CUDA unless given
``device="cpu"``, and import nothing of JAX, PIL, cv2 or the JAX package
(checked in a subprocess).  scripts/torch_latency_bench.py at T=1 and 2,
and scripts/torch_fleet_bench.py at S=2, T=4 under one load, give rows
with their keys; the fleet's outputs equal ``StreamFleet.step``'s.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tests.conftest import ASSETS_DIR
from tests.test_torch_host import BLOCK_IMPORTS, REPO
from tests.test_torch_pipeline import DECISIONS, curve_rmse
from tests.torch_scripts import load_script

from lane_tracker_tpu.calib.io import load_calibration_npz as j_load
from lane_tracker_tpu.parallel.pipeline import chunk_process as j_chunk
from lane_tracker_tpu.tracker import step as j_step
from lane_tracker_tpu.tracker.config import PRESETS

sys.path.insert(0, str(REPO))
import bench_torch as bt  # noqa: E402

from lane_tracker_tpu_torch.parallel import StreamFleet  # noqa: E402

T = 8
VARIANTS = {"stills": {}, "fail16": {"fail_every": 16},
            "motion": {"motion": True}}
FIT_CONTRACT_PX = 0.01
LINE_KEYS = ("metric", "value", "unit", "chunk_size", "valid_fraction",
             "rmse_px_max", "rmse_px_mean", "rmse_gate_frames",
             "bench_variant", "chunk_ms_median", "chunk_ms_min",
             "chunk_ms_max", "wall_ms_median", "timed_chunks",
             "peak_mem_gib", "device")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread for this module, restored after: the back half
    runs thousands of small operators, which the intra-op pool slows down
    when the suite's workers share the cores (tests/test_torch_fleet.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's chunk_process on each variant's T frames from a fresh state:
    {variant: (frames, outputs)}."""
    cam, warp = j_load(ASSETS_DIR / "calibration.npz")
    jp = j_step.TrackerParams.build(
        cam.cam_matrix, cam.dist_coeffs, warp.M, warp.Minv,
        warp.image_width_height, warp.warped_width_height, warp.mppv,
        warp.mpph, pipeline="corridor", filter_backend="xla")
    cfg = PRESETS["demo1"]
    run = jax.jit(lambda s, f, p: j_chunk(s, f, p, cfg, True,
                                          second_attempt="two_phase"))
    out = {}
    for name, kw in VARIANTS.items():
        frames = bt.make_frames(T, kw.get("fail_every", 0),
                                kw.get("motion", False), "cpu").numpy()
        _, jo = run(j_step.make_initial_state(cfg, jp.warped_size), frames,
                    jp)
        out[name] = (frames, jo)
    return out


def recorder(monkeypatch, edit=None):
    """Patch bench_torch's chunk processor to record each call's pipeline
    and outputs (``edit`` may change the outputs first); returns the
    list of records."""
    calls = []
    real = bt.build_chunk_processor

    def build(config, **kw):
        fn = real(config, **kw)

        def step(state, frames, params):
            state, outs = fn(state, frames, params)
            if edit is not None:
                outs = edit(params, outs)
            calls.append((params.pipeline, frames.clone(), outs))
            return state, outs
        return step

    monkeypatch.setattr(bt, "build_chunk_processor", build)
    return calls


def bench_py_rmse(valid, left, right, oracle, n_gate, H):
    """bench.py:257-269 as written there, on numpy outputs."""
    ov, ol, orr = (oracle["valid"][:n_gate], oracle["left"][:n_gate],
                   oracle["right"][:n_gate])
    mv = np.asarray(valid)[:n_gate]
    yy = np.arange(H, dtype=float)
    rs = []
    for t in range(n_gate):
        if not (ov[t] and mv[t]):
            continue
        for mine, ref in ((np.asarray(left[t], float), ol[t]),
                          (np.asarray(right[t], float), orr[t])):
            rs.append(np.sqrt(np.mean(
                (np.polyval(mine, yy) - np.polyval(ref, yy)) ** 2)))
    return float(np.max(rs)), float(np.mean(rs))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bench_matches_jax_and_oracle(variant, jax_runs, monkeypatch):
    calls = recorder(monkeypatch)
    kw = VARIANTS[variant]
    line = bt.run(T=T, n_chunks=0, device="cpu", **kw)
    frames, jo = jax_runs[variant]
    (pipeline, first_frames, to), = calls  # the gated chunk alone
    np.testing.assert_array_equal(first_frames.numpy(), frames)
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    H = 1100
    for side in ("left_coeffs", "right_coeffs"):
        for a, b in zip(getattr(to, side).numpy(),
                        np.asarray(getattr(jo, side))):
            assert curve_rmse(a, b, H) <= FIT_CONTRACT_PX, side
    with np.load(bt.oracle_path(kw.get("fail_every", 0),
                                kw.get("motion", False))) as z:
        oracle = {k: z[k] for k in ("valid", "left", "right")}
    np.testing.assert_array_equal(to.valid.numpy(), oracle["valid"][:T])
    if variant == "fail16":
        assert not np.asarray(jo.a1_valid)[0]  # the fallback ran
        assert (to.n_attempts.numpy() == 2).any()
    j_max, j_mean = bench_py_rmse(jo.valid, jo.left_coeffs, jo.right_coeffs,
                                  oracle, T, H)
    print(f"{variant}: rmse_px_max port {line['rmse_px_max']}, bench.py's "
          f"formula on JAX {j_max}")
    assert abs(line["rmse_px_max"] - j_max) <= FIT_CONTRACT_PX
    assert abs(line["rmse_px_mean"] - j_mean) <= FIT_CONTRACT_PX
    assert all(k in line for k in LINE_KEYS)
    assert "vs_baseline" not in line and "vs_target_2000fps" not in line
    assert line["bench_variant"] == variant and line["chunk_size"] == T
    assert line["rmse_gate_frames"] == T
    assert line["valid_fraction"] == float(np.asarray(jo.valid).mean())
    assert line["pipeline"] == "corridor" and line["certified_exact"]
    assert line["corridor_ok_fraction"] == 1.0
    assert line["valid_mismatch_frames"] == 0
    assert line["timed_chunks"] == 0 and line["value"] is None
    assert line["device"] == {"name": "cpu", "power_limit": None}


def _no_certificate(params, outs):
    if params.pipeline != "corridor":
        return outs
    return outs._replace(corridor_ok=torch.zeros_like(outs.corridor_ok))


def test_failed_certificate_falls_back_to_fast(monkeypatch):
    calls = recorder(monkeypatch, _no_certificate)
    line = bt.run(T=2, n_chunks=1, device="cpu")
    assert [p for p, _, _ in calls] == ["corridor", "fast", "fast", "fast"]
    assert line["pipeline"] == "fast"
    assert line["certified_exact"] is False
    assert line["corridor_ok_fraction"] == 0.0
    assert line["corridor_failed_frames"] == 2
    assert line["rmse_px_max"] <= bt.RMSE_LIMIT_PX  # 'fast' is gated
    assert all(k in line for k in LINE_KEYS) and line["timed_chunks"] == 1
    assert line["value"] == pytest.approx(2 / line["chunk_ms_median"] * 1e3)
    assert line["chunk_ms_min"] <= line["chunk_ms_median"]
    assert line["peak_mem_gib"] is None


def test_explicit_corridor_raises_on_a_failed_certificate(monkeypatch):
    calls = recorder(monkeypatch, _no_certificate)
    with pytest.raises(AssertionError, match="corridor certificate failed"):
        bt.run(T=2, pipeline="corridor", n_chunks=1, device="cpu")
    assert [p for p, _, _ in calls] == ["corridor"]


def test_main_reads_bench_py_environment(monkeypatch, capsys):
    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return {"value": 1.0}

    monkeypatch.setattr(bt, "run", fake_run)
    for k in ("BENCH_T", "BENCH_PIPELINE", "BENCH_FAIL_EVERY",
              "BENCH_MOTION", "BENCH_CHUNKS"):
        monkeypatch.delenv(k, raising=False)
    assert bt.main() == 0
    assert seen == {"T": 512, "pipeline": None, "fail_every": 0,
                    "motion": False, "n_chunks": 5}
    monkeypatch.setenv("BENCH_PIPELINE", "corridor")
    monkeypatch.setenv("BENCH_T", "64")
    monkeypatch.setenv("BENCH_FAIL_EVERY", "16")
    monkeypatch.setenv("BENCH_MOTION", "1")
    monkeypatch.setenv("BENCH_CHUNKS", "2")
    bt.main()
    assert seen == {"T": 64, "pipeline": "corridor", "fail_every": 16,
                    "motion": True, "n_chunks": 2}
    assert capsys.readouterr().out.splitlines()[-1] == '{"value": 1.0}'


def _edit_oracle(tmp_path, how):
    with np.load(ASSETS_DIR / "bench_oracle.npz") as z:
        arrays = {k: z[k].copy() for k in z.files}
    if how == "valid":
        arrays["valid"][1] = ~arrays["valid"][1]
    else:  # move frame 0's left curve by 1 px
        arrays["left"][0, 2] += 1.0
    path = tmp_path / "bench_oracle.npz"
    np.savez(path, **arrays)
    return path


def _oracle_at(monkeypatch, path):
    monkeypatch.setattr(bt, "oracle_path", lambda fail_every, motion: path)


@pytest.mark.parametrize("how, match", [
    ("valid", "validity trace diverges"),
    ("curve", "rmse_px_max .* exceeds 0.5"),
])
def test_broken_oracle_makes_the_run_raise(how, match, tmp_path,
                                           monkeypatch):
    _oracle_at(monkeypatch, _edit_oracle(tmp_path, how))
    with pytest.raises(AssertionError, match=match):
        bt.run(T=2, n_chunks=1, device="cpu")


def test_missing_oracle(tmp_path, monkeypatch):
    assert not bt.oracle_path(3, False).exists()
    line = bt.run(T=2, fail_every=3, n_chunks=1, device="cpu")
    assert line["bench_variant"] == "fail3"
    assert line["rmse_px_max"] is None and line["rmse_gate_frames"] is None
    _oracle_at(monkeypatch, tmp_path / "none.npz")
    with pytest.raises(FileNotFoundError, match="stills oracle"):
        bt.run(T=2, n_chunks=1, device="cpu")


@pytest.mark.parametrize("entry", ["bench", "latency", "fleet"])
def test_default_device_needs_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default runs")
    call = {
        "bench": lambda: bt.run(T=2, n_chunks=1),
        "latency": lambda: load_script("torch_latency_bench").main(["1"]),
        "fleet": lambda: load_script("torch_fleet_bench").main(["2", "4"]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


_IMPORT = BLOCK_IMPORTS + """
import importlib.util, runpy
sys.path.insert(0, {repo!r})
spec = importlib.util.spec_from_file_location("entry", {path!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "PIL", "cv2", "lane_tracker_tpu"))
assert not bad, bad
assert "lane_tracker_tpu_torch.parallel.pipeline" in sys.modules
print("ok")
"""


@pytest.mark.parametrize("path", ["bench_torch.py",
                                  "scripts/torch_latency_bench.py",
                                  "scripts/torch_fleet_bench.py"])
def test_entry_points_import_no_jax(path):
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT.format(
            mods=("jax", "PIL", "cv2", "lane_tracker_tpu"),
            repo=str(REPO), path=str(REPO / path))],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


LATENCY_KEYS = ("pipeline", "chunk", "fps", "ms_per_frame",
                "chunk_compute_ms", "peak_mem_gib", "device")


def test_latency_rows(monkeypatch, capsys):
    monkeypatch.delenv("LATENCY_ROWMM", raising=False)
    mod = load_script("torch_latency_bench")
    monkeypatch.setattr(mod, "MIN_SECONDS", 0.0)
    monkeypatch.setattr(mod, "MIN_CHUNKS", 1)
    rows = mod.main(["1", "2"], device="cpu")
    assert [(r["pipeline"], r["chunk"]) for r in rows] == [
        ("corridor", 1), ("corridor", 2), ("fast", 1), ("fast", 2)]
    for r in rows:
        assert all(k in r for k in LATENCY_KEYS) and "resampler" not in r
        assert r["fps"] == pytest.approx(r["chunk"] * 1e3
                                         / r["chunk_compute_ms"])
        assert r["ms_per_frame"] == pytest.approx(r["chunk_compute_ms"]
                                                  / r["chunk"])
        assert r["timed_chunks"] == 1 and r["peak_mem_gib"] is None
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == len(rows)


def test_fleet_rows_and_outputs(monkeypatch):
    """Under 'auto' (one settling step: EMA 0.25, so two_phase) on
    fail16, 'corridor'; the measured fleet's first step equals a fresh
    ``StreamFleet.step`` on the load's frames."""
    mod = load_script("torch_fleet_bench")
    monkeypatch.setenv("FLEET_LOADS", "fail16")
    monkeypatch.setenv("FLEET_SCHEDULES", "auto")
    monkeypatch.setenv("FLEET_PIPELINE", "corridor")
    firsts = []
    real = mod.measure

    def measure(*args):
        got = real(*args)
        firsts.append(got[:2])
        return got

    monkeypatch.setattr(mod, "measure", measure)
    monkeypatch.setattr(mod, "TIMED_STEPS", 1)
    monkeypatch.setattr(mod, "AUTO_STEPS", 1)
    rows = mod.main(["2", "4"], device="cpu")
    (row,), ((outs, metrics),) = rows, firsts
    assert (row["schedule"], row["load"], row["resolved_schedule"]) == (
        "auto", "fail16", "two_phase")
    assert (row["streams"], row["chunk"], row["timed_steps"]) == (2, 4, 1)
    assert row["aggregate_fps"] == pytest.approx(8e3 / row["step_ms_median"])
    assert row["ms_per_frame"] == pytest.approx(row["step_ms_median"] / 8)
    assert row["peak_mem_gib"] is None and row["pipeline"] == "corridor"
    frames = mod.load_frames(2, 4)["fail16"]
    assert (frames[0, 0] == 0).all() and frames[1].any()
    fleet = StreamFleet(bt.build_params("corridor", "cpu"), PRESETS["demo1"],
                        2, mesh=("cpu",), with_overlay=True)
    want, want_metrics = fleet.step(frames)
    for f in want._fields:
        assert torch.equal(getattr(outs, f), getattr(want, f)), f
    assert {k: int(v) for k, v in metrics.items()} == {
        k: int(v) for k, v in want_metrics.items()}
    assert row["valid_fraction"] == float(want.valid.float().mean())
    assert not want.a1_valid[0, 0]  # the fallback ran
