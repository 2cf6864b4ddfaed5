"""Serving beyond one frame at a time.

``pipeline.chunk_process`` runs one stream's chunk of T frames (a batched
front half, the sequential back half, the overlays).  The fleet serves
many streams at once: ``streams.StreamFleet`` (and the processor under
it, ``streams.build_fleet_processor``) steps S streams in lockstep chunks,
sharded over a device list (``mesh.stream_mesh``, ``mesh.shard_streams``),
each device's front half on all its streams' frames in one batch and the
back half batched over its streams.  ``pipeline.build_chunk_processor`` is
the chunk processor cached per config.  ``mesh.stream_row_mesh``, the
reference's streams x rows mesh, is exported as the reference exports
it; no program consumes it.
"""

from lane_tracker_tpu_torch.parallel.mesh import (
    shard_streams,
    stream_mesh,
    stream_row_mesh,
)
from lane_tracker_tpu_torch.parallel.pipeline import (
    build_chunk_processor,
    chunk_process,
)
from lane_tracker_tpu_torch.parallel.streams import (
    StreamFleet,
    build_fleet_processor,
)

__all__ = [
    "build_chunk_processor",
    "chunk_process",
    "StreamFleet",
    "build_fleet_processor",
    "stream_mesh",
    "stream_row_mesh",
    "shard_streams",
]
