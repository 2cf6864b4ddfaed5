"""The port's banded warp (``MxuWarp2``) against the JAX script's.

scripts/resample_mxu2.py is loaded by path (as tests/test_longrun.py loads
scripts/motion_longrun.py) and built from ``assets/calibration.npz`` at a
reduced bird's-eye size, ``dst_size=(256, 96)``; its ``__call__`` runs
eagerly with the Pallas pass 2 in interpret mode on the CPU.  Inputs, T=2:
the (R, B) channels of two stills, and channels made from a seed with
numpy.

Tolerance: the built tables equal JAX's exactly (values and dtypes); pass
1's f32 planes equal JAX's exactly; the warped output equals JAX's, with
the count of differing values stated in the assertion (0 expected: the
twin takes pass 2's fma in the order JAX's f32 dot forms it, each fma a
float64 ``a*b + c`` rounded once to f32).  The CUDA kernel is held
against the twin on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import ASSETS_DIR

from lane_tracker_tpu_torch.calib.io import load_calibration_npz
from lane_tracker_tpu_torch.kernels import resample_mxu2 as rm
from torch_scripts import load_script

DST = (256, 96)


def _calib():
    cam, warp = load_calibration_npz(ASSETS_DIR / "calibration.npz")
    return cam.cam_matrix, cam.dist_coeffs, warp.M, warp.image_width_height


@pytest.fixture(scope="module")
def warps():
    """(JAX MxuWarp2, the port's MxuWarp2 on the CPU) at DST."""
    jw = load_script("resample_mxu2").MxuWarp2.build(*_calib(), DST)
    tw = rm.MxuWarp2.build(*_calib(), DST, device="cpu")
    return jw, tw


def _pairs(kind):
    """(2, 2, 720, 1280) uint8 (R, B) pairs."""
    if kind == "stills":
        with np.load(ASSETS_DIR / "stills_720p.npz") as z:
            fr = z["frames"][[2, 0]]
        return np.ascontiguousarray(fr[..., [0, 2]].transpose(0, 3, 1, 2))
    return np.random.default_rng(3).integers(0, 256, (2, 2, 720, 1280),
                                             dtype=np.uint8)


def test_tables_equal_jax(warps):
    jw, tw = warps
    assert tw.geom == jw.geom == (1280, 720, 256, 96, 640)
    for name in ("v_base", "v_w0", "v_w1", "wpack", "tile_base"):
        want = np.asarray(getattr(jw, name))
        got = getattr(tw, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("kind", ["stills", "random"])
def test_warp_equals_jax(warps, kind):
    jw, tw = warps
    pairs = _pairs(kind)
    want = np.asarray(jw(jnp.asarray(pairs), interpret=True))
    want_t1 = [np.asarray(x) for x in jax.vmap(
        lambda f: jw._pass1(f[0], f[1]))(jnp.asarray(pairs))]
    rm.reset_launches()
    got_t1 = tw.pass1(torch.from_numpy(pairs))
    got = tw(torch.from_numpy(pairs))
    assert rm.LAUNCHES["banded_pass2"] == 0
    for c in range(2):
        np.testing.assert_array_equal(got_t1[:, c].numpy(), want_t1[c])
    assert got.shape == want.shape == (2, 2, 96, 256)
    n_diff = int((got.numpy() != want).sum())
    assert n_diff == 0, f"{n_diff} of {want.size} warped values differ"
    one = tw(torch.from_numpy(pairs[1]))
    np.testing.assert_array_equal(one.numpy(), want[1])


@pytest.mark.parametrize("bad", ["t1_dtype", "wpack_shape", "width",
                                 "device"])
def test_pass2_rejects_bad_inputs(bad):
    t1 = torch.zeros((1, 2, 4, 16), dtype=torch.float32)
    wpack = torch.zeros((4, 1, 4, rm.LANE), dtype=torch.float32)
    width = 10
    if bad == "t1_dtype":
        t1 = t1.double()
    elif bad == "wpack_shape":
        wpack = wpack[:3]
    elif bad == "width":
        width = rm.LANE + 1
    else:
        t1 = t1.to("meta")
    with pytest.raises(ValueError):
        rm.pass2(t1, wpack, width)
