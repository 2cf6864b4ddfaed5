"""Calibration container I/O (numpy only).

Copied from lane_tracker_tpu/calib/io.py (CameraParams, WarpParams,
load_camera_calib, load_warp_params, save_calibration_npz,
load_calibration_npz; io.py:16-135); tests/test_torch_host.py pins it
equal to the original.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np

_NPZ_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Pinhole camera intrinsics + Brown-Conrady distortion coefficients."""

    cam_matrix: np.ndarray  # (3, 3) float64
    dist_coeffs: np.ndarray  # (N,) float64, N in {4, 5, 8, 12, 14}

    def __post_init__(self):
        object.__setattr__(
            self, "cam_matrix", np.asarray(self.cam_matrix, dtype=np.float64)
        )
        object.__setattr__(
            self,
            "dist_coeffs",
            np.asarray(self.dist_coeffs, dtype=np.float64).reshape(-1),
        )
        if self.cam_matrix.shape != (3, 3):
            raise ValueError(f"cam_matrix must be 3x3, got {self.cam_matrix.shape}")


@dataclasses.dataclass(frozen=True)
class WarpParams:
    """Bird's-eye-view homography pair + geometry + metric conversion."""

    M: np.ndarray  # (3, 3) forward homography: camera view -> bird's-eye
    Minv: np.ndarray  # (3, 3) inverse homography
    image_width_height: tuple  # (W, H) of raw camera frames
    warped_width_height: tuple  # (W, H) of the bird's-eye view
    mppv: float  # meters per pixel, vertical
    mpph: float  # meters per pixel, horizontal

    def __post_init__(self):
        object.__setattr__(self, "M", np.asarray(self.M, dtype=np.float64))
        object.__setattr__(self, "Minv", np.asarray(self.Minv, dtype=np.float64))
        object.__setattr__(
            self, "image_width_height", tuple(int(v) for v in self.image_width_height)
        )
        object.__setattr__(
            self,
            "warped_width_height",
            tuple(int(v) for v in self.warped_width_height),
        )


def load_camera_calib(filepath):
    """Load camera matrix and distortion coefficients from a reference pickle.

    Matches the payload contract of the reference loader (utils.py:13-26).

    Returns:
        (cam_matrix, dist_coeffs) numpy arrays.
    """
    with open(filepath, "rb") as f:
        payload = pickle.load(f)
    cam_matrix = np.asarray(payload["cam_matrix"], dtype=np.float64)
    dist_coeffs = np.asarray(payload["dist_coeffs"], dtype=np.float64)
    return cam_matrix, dist_coeffs


def load_warp_params(filepath):
    """Load bird's-eye warp parameters from a reference pickle.

    Matches the payload contract of the reference loader (utils.py:28-55).

    Returns:
        (M, Minv, image_width_height, warped_width_height, mppv, mpph)
    """
    with open(filepath, "rb") as f:
        payload = pickle.load(f)
    return (
        np.asarray(payload["M"], dtype=np.float64),
        np.asarray(payload["Minv"], dtype=np.float64),
        payload["image_width_height"],
        payload["warped_width_height"],
        float(payload["mppv"]),
        float(payload["mpph"]),
    )


def save_calibration_npz(filepath, camera: CameraParams, warp: WarpParams):
    """Persist both parameter sets in the framework's native npz container."""
    np.savez(
        filepath,
        schema_version=np.int64(_NPZ_SCHEMA_VERSION),
        cam_matrix=camera.cam_matrix,
        dist_coeffs=camera.dist_coeffs,
        M=warp.M,
        Minv=warp.Minv,
        image_width_height=np.asarray(warp.image_width_height, dtype=np.int64),
        warped_width_height=np.asarray(warp.warped_width_height, dtype=np.int64),
        mppv=np.float64(warp.mppv),
        mpph=np.float64(warp.mpph),
    )


def load_calibration_npz(filepath):
    """Load a (CameraParams, WarpParams) pair from the native npz container."""
    with np.load(filepath) as z:
        version = int(z["schema_version"])
        if version > _NPZ_SCHEMA_VERSION:
            raise ValueError(f"Unsupported calibration schema version {version}")
        camera = CameraParams(z["cam_matrix"], z["dist_coeffs"])
        warp = WarpParams(
            z["M"],
            z["Minv"],
            tuple(z["image_width_height"]),
            tuple(z["warped_width_height"]),
            float(z["mppv"]),
            float(z["mpph"]),
        )
    return camera, warp
