"""lane_tracker_tpu_torch: the lane tracker on PyTorch and CUDA.

A port of ``lane_tracker_tpu`` (JAX, the reference) to PyTorch, with the
TPU package's Pallas filter kernels rewritten as hand-made CUDA kernels
for Hopper (``csrc/``, built with nvcc at first use).  The package imports
neither jax nor PIL, and nothing of ``lane_tracker_tpu``; the host-side
numpy helpers it needs are copies that name their source.  Only the
image-directory source and sink (``io/video.py``) take PIL, when they are
constructed.

Top-level API, as the reference's:
    LaneTracker          -- stateful wrapper matching the reference API
                            (per frame ``process``, per chunk
                            ``process_chunk``, state snapshots)
    TrackerConfig, PRESETS
    load_camera_calib, load_warp_params, load_calibration_npz,
    save_calibration_npz -- calibration loaders

and the CLI, ``python -m lane_tracker_tpu_torch input output --preset
demo1``.  Underneath, ``parallel.pipeline.chunk_process`` is the chunk
pipeline and ``tracker.step.build_step`` the per-frame step.  The entry
points that make tensors put them on the card unless the caller passes
``device="cpu"`` (``device.py``).
"""

from lane_tracker_tpu_torch.calib.io import (
    load_calibration_npz,
    load_camera_calib,
    load_warp_params,
    save_calibration_npz,
)
from lane_tracker_tpu_torch.tracker.config import PRESETS, TrackerConfig
from lane_tracker_tpu_torch.tracker.tracker import LaneTracker

__version__ = "0.1.0"

__all__ = [
    "LaneTracker",
    "TrackerConfig",
    "PRESETS",
    "load_camera_calib",
    "load_warp_params",
    "load_calibration_npz",
    "save_calibration_npz",
    "__version__",
]
