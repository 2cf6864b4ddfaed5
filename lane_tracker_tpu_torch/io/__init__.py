from lane_tracker_tpu_torch.io.video import (
    FrameSource,
    FrameSink,
    open_source,
    open_sink,
    FfmpegSource,
    FfmpegSink,
    ImageDirSource,
    ImageDirSink,
    NpzSource,
    NpzSink,
)

__all__ = [
    "FrameSource",
    "FrameSink",
    "open_source",
    "open_sink",
    "FfmpegSource",
    "FfmpegSink",
    "ImageDirSource",
    "ImageDirSink",
    "NpzSource",
    "NpzSink",
]
