"""The overlays: the lane region drawn on camera frames, and text."""

from lane_tracker_tpu_torch.render.lane import lane_overlay, lane_region_mask
from lane_tracker_tpu_torch.render.text import draw_text

__all__ = ["lane_overlay", "lane_region_mask", "draw_text"]
