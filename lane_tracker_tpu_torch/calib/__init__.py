from lane_tracker_tpu_torch.calib.homography import perspective_grid
from lane_tracker_tpu_torch.calib.io import (
    CameraParams,
    WarpParams,
    load_calibration_npz,
)
from lane_tracker_tpu_torch.calib.undistort import undistort_grid

__all__ = [
    "CameraParams",
    "WarpParams",
    "load_calibration_npz",
    "perspective_grid",
    "undistort_grid",
]
