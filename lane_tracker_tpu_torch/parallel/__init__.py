"""Serving beyond one frame at a time.

``pipeline.chunk_process`` runs one stream's chunk of T frames (a batched
front half, the sequential back half, the overlays).  The fleet serves
many streams at once: ``streams.StreamFleet`` (and the processor under
it, ``streams.build_fleet_processor``) steps S streams in lockstep chunks,
sharded over a device list (``mesh.stream_mesh``, ``mesh.shard_streams``),
each device's front half on all its streams' frames in one batch and the
back half batched over its streams.
"""

from lane_tracker_tpu_torch.parallel.mesh import shard_streams, stream_mesh
from lane_tracker_tpu_torch.parallel.pipeline import chunk_process
from lane_tracker_tpu_torch.parallel.streams import (
    StreamFleet,
    build_fleet_processor,
)

__all__ = [
    "chunk_process",
    "StreamFleet",
    "build_fleet_processor",
    "stream_mesh",
    "shard_streams",
]
