"""The generator is io/motion.py's arithmetic: at phase 0 its frames equal
the port's, and the seed moves only the jitter's phases."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.traffic import motion

ROOT = pathlib.Path(__file__).resolve().parents[2]
MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "benchmark" / "traffic").glob("*.json")}


def test_frames_equal_io_motion_at_phase_zero():
    from lane_tracker_tpu_torch.io import motion as port

    scenes = motion.load_scenes(ROOT, "cpu")
    ts = [0, 151, 301]
    inv = np.stack([motion.invert_affine(motion.frame_matrix(
        t, 1280, 720, (0.0, 0.0, 0.0, 0.0))) for t in ts])
    src = scenes[torch.tensor([(t // 150) % 3 for t in ts])]
    got = motion.warp_affine(src, inv)
    for j, t in enumerate(ts):
        want = port.motion_frame(t, port.load_scenes("cpu"))
        assert torch.equal(got[j], want), t


def test_jitter_and_matrix_equal_io_motion_at_phase_zero():
    from lane_tracker_tpu_torch.io import motion as port

    for t in (0, 7, 450, 999):
        assert motion.jitter(t) == pytest.approx(port.jitter(t), abs=0)
        assert np.array_equal(motion.frame_matrix(t, 1280, 720, (0,) * 4),
                              port.frame_matrix(t, 1280, 720))


def test_seed_moves_phases_only():
    a, b = motion.phases(1, 4), motion.phases(2**31 + 5, 4)
    assert a.shape == (4, 4) and not np.allclose(a, b)
    assert np.array_equal(a, motion.phases(1, 4))
    assert ((0 <= b) & (b < 2 * np.pi)).all()
    assert motion.phases(-3, 2).shape == (2, 4)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_work_per_chunk_is_the_same_for_two_seeds(name):
    """The plan (which scene each pool frame shows, which are black)
    does not take the seed; so two seeds make the same work."""
    mix = MIXES[name]
    plan = motion.pool_plan(mix, 16)
    assert plan == motion.pool_plan(dict(mix), 16)
    black = {first + k for first, n in mix["dropouts"] for k in range(n)}
    for frames in plan:
        assert len(frames) == mix["pool_frames"]
        assert {i for i, (_, s) in enumerate(frames) if s < 0} == black


def test_motion_drop_is_motion_chunk_512():
    from lane_tracker_tpu_torch.io import motion as port

    (frames,) = motion.pool_plan(MIXES["motion-drop"], 1)
    for t, scene in frames:
        want = -1 if port.is_dropout(t) else (t // 150) % 3
        assert scene == want


def test_motion_clean_streams_avoid_scene_one_and_black():
    plan = motion.pool_plan(MIXES["motion-clean"], 16)
    scenes = {s for frames in plan for _, s in frames}
    assert scenes == {0, 2}
    assert [frames[0][1] for frames in plan] == [0, 2] * 8


def test_pools_on_the_device_of_the_call():
    mix = dict(MIXES["motion-drop"], pool_frames=3, dropouts=[[1, 1]])
    pools = motion.make_pools(mix, 99, 2, "cpu", ROOT)
    assert pools.shape == (2, 3, 720, 1280, 3)
    assert pools.dtype == torch.uint8
    assert int(pools[:, 1].max()) == 0 and int(pools[:, 0].max()) > 0
    assert not torch.equal(pools[0, 0], pools[1, 0])  # phases per stream
