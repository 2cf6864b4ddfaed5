from lane_tracker_tpu_torch.calib.homography import perspective_grid
from lane_tracker_tpu_torch.calib.io import (
    CameraParams,
    WarpParams,
    load_calibration_npz,
    load_camera_calib,
    load_warp_params,
    save_calibration_npz,
)
from lane_tracker_tpu_torch.calib.undistort import undistort_grid

__all__ = [
    "CameraParams",
    "WarpParams",
    "load_calibration_npz",
    "load_camera_calib",
    "load_warp_params",
    "perspective_grid",
    "save_calibration_npz",
    "undistort_grid",
]
