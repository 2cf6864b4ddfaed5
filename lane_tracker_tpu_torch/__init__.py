"""lane_tracker_tpu_torch: the lane tracker on PyTorch and CUDA.

A port of ``lane_tracker_tpu`` (JAX, the reference) to PyTorch, with the
TPU package's Pallas filter kernels rewritten as hand-made CUDA kernels
for Hopper (``csrc/``, built with nvcc at first use).  The package imports
neither jax nor PIL, and nothing of ``lane_tracker_tpu``; the host-side
numpy helpers it needs are copies that name their source.

Entry point: ``parallel.pipeline.chunk_process`` with params from
``tracker.step.TrackerParams.build(..., pipeline="corridor")`` and a state
from ``tracker.step.make_initial_state``.  The entry points that make
tensors put them on the card unless the caller passes ``device="cpu"``
(``device.py``).
"""

__version__ = "0.1.0"
