"""The port's CLI, ``python -m lane_tracker_tpu_torch``, against the JAX
package's, and the raw RGB24 frame I/O.

The port's CLI runs in a subprocess that cannot import jax, PIL or the
JAX package (``BLOCK_IMPORTS`` of tests/test_torch_host.py), on the CPU
(``--device cpu``: the kernels' plain versions), over a 4-frame ``.npz``
of the stills with ``--chunk 4 --per-frame-log --metrics-json``.  JAX's
``lane_tracker_tpu.process_video.run`` runs in this test's own process
(the suite already runs JAX on the CPU here) on the same input and
arguments.  Tolerances: exit 0; the per-frame logs equal line for line;
the metrics and the printed success lines equal, apart from ``fps``; the
output frames within 1 unit ('fast' demo1 on the stills draws no lane
edge at the fit contract: tests/test_torch_pipeline_fast.py).

The ``.rgb24`` round trip: a stack written by ``write_rgb24`` (and by the
sink) reads back equal through the native loader (the C++ library the
port builds from native/frame_loader.cpp) and through the memmap reader,
tail chunk padded alike.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import ASSETS_DIR
from tests.test_torch_host import BLOCK_IMPORTS, REPO

from lane_tracker_tpu.process_video import run as j_run

from lane_tracker_tpu_torch.io import native_loader as nl

_CLI = BLOCK_IMPORTS + """
import runpy
sys.argv = ["lane_tracker_tpu_torch"] + {argv!r}
runpy.run_module("lane_tracker_tpu_torch", run_name="__main__",
                 alter_sys=True)
"""


def _stills():
    with np.load(ASSETS_DIR / "stills_720p.npz") as z:
        return z["frames"]


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    src = tmp / "stills.npz"
    np.savez(src, frames=_stills())
    outs = {}
    for who in ("jax", "port"):
        outs[who] = dict(out=tmp / f"{who}_out.npz",
                         log=tmp / f"{who}_log.jsonl",
                         metrics=tmp / f"{who}_metrics.json")
    argv = {who: [str(src), str(o["out"]), "--calibration",
                  str(ASSETS_DIR / "calibration.npz"), "--chunk", "4",
                  "--per-frame-log", str(o["log"]),
                  "--metrics-json", str(o["metrics"])]
            for who, o in outs.items()}
    res = subprocess.run(
        [sys.executable, "-c", _CLI.format(
            mods=("jax", "PIL", "lane_tracker_tpu"),
            argv=argv["port"] + ["--device", "cpu"])],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    outs["port"]["rc"] = res.returncode
    outs["port"]["stdout"] = res.stdout
    outs["port"]["stderr"] = res.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        outs["jax"]["rc"] = j_run(argv["jax"])
    outs["jax"]["stdout"] = buf.getvalue()
    return outs


def _success_lines(stdout):
    return [line for line in stdout.splitlines()
            if line.startswith("Success ")]


def test_cli_runs_without_jax_and_pil(clis):
    port = clis["port"]
    assert port["rc"] == 0, port["stderr"]
    assert clis["jax"]["rc"] == 0
    lines = port["stdout"].splitlines()
    assert lines[-1].startswith("Frames: 4 at ") and "fps" in lines[-1]


def test_cli_log_and_metrics_match_jax(clis):
    j, t = clis["jax"], clis["port"]
    jl = j["log"].read_text().splitlines()
    tl = t["log"].read_text().splitlines()
    assert len(tl) == 4 and tl == jl
    assert [json.loads(x)["valid"] for x in tl] == [True] * 4
    jm, tm = (json.loads(o["metrics"].read_text()) for o in (j, t))
    # One chunk: the steady-state meter excludes the first, so both
    # packages meter no frame.
    assert jm.pop("fps") == tm.pop("fps") == 0.0
    assert tm == jm == {"frames": 4, "valid_frames": 4, "success_ratio": 1.0}
    assert _success_lines(t["stdout"]) == _success_lines(j["stdout"])


def test_cli_frames_match_jax(clis):
    with np.load(clis["jax"]["out"]) as z:
        jf = z["frames"]
    with np.load(clis["port"]["out"]) as z:
        tf = z["frames"]
    assert tf.shape == jf.shape == (4, 720, 1280, 3)
    d = np.abs(tf.astype(int) - jf.astype(int))
    print(f"CLI frames: {int((d != 0).sum())} of {d.size} values differ")
    assert d.max() <= 1
    assert (tf != _stills()).any()  # the lane and the text were drawn


@pytest.mark.parametrize("native", [True, False])
def test_rgb24_round_trip(tmp_path, native):
    frames = _stills()[[0, 1, 2, 3, 0]]
    path = tmp_path / "clip.rgb24"
    nl.write_rgb24(path, frames, fps=30.0)
    src = nl.RawRGB24Source(path, prefer_native=native)
    assert src.size == (1280, 720) and src.fps == 30.0
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    assert src.native == (native and cxx is not None)
    chunks = list(src.chunks(3))
    assert [n for _, n in chunks] == [3, 2]
    np.testing.assert_array_equal(chunks[0][0], frames[:3])
    np.testing.assert_array_equal(chunks[1][0][:2], frames[3:])
    np.testing.assert_array_equal(chunks[1][0][2], frames[4])  # padded
    # And back out through the sink.
    sink = nl.RawRGB24Sink(tmp_path / "copy.rgb24", src.size, src.fps)
    for chunk, n in chunks:
        sink.write(chunk, n)
    sink.close()
    back = nl.RawRGB24Source(tmp_path / "copy.rgb24", prefer_native=native)
    got = np.concatenate([c[:n] for c, n in back.chunks(5)])
    np.testing.assert_array_equal(got, frames)
    assert back.fps == 30.0


def test_profile_dir_writes_a_trace(tmp_path):
    """``--profile-dir``'s context: a torch.profiler trace of the region,
    written as Chrome trace JSON, with the region's ranges in it."""
    import torch

    from lane_tracker_tpu_torch.utils.profiling import maybe_profile, span

    with maybe_profile(None):
        pass
    assert not any(tmp_path.iterdir())
    with maybe_profile(tmp_path / "trace"):
        with span("lt.test_region"):
            torch.ones(64).cumsum(0)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "lt.test_region"
               for e in events["traceEvents"])
