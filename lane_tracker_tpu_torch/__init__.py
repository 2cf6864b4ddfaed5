"""lane_tracker_tpu_torch: the lane tracker on PyTorch and CUDA.

A port of ``lane_tracker_tpu`` (JAX, the reference) to PyTorch, with the
TPU package's Pallas filter kernels rewritten as hand-made CUDA kernels
for Hopper (``csrc/``, built with nvcc at first use).  The package imports
neither jax nor PIL, and nothing of ``lane_tracker_tpu``; the host-side
numpy helpers it needs are copies that name their source.

Entry point: ``parallel.pipeline.chunk_process`` with params from
``tracker.step.TrackerParams.build(..., pipeline="corridor")``.
"""

__version__ = "0.1.0"
