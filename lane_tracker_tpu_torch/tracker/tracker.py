"""Stateful LaneTracker wrapper with the reference-compatible API.

Port of lane_tracker_tpu/tracker/tracker.py:33-433: the same constructor
(plus ``device``), ``process()`` keyword surface and defaults
(lane_tracker.py:876-900), ``process_chunk``, ``save_state`` /
``load_state``, ``get_success_ratio()`` (lane_tracker.py:178-181) and the
diagnostics narration, print for print.  Per-call kwargs become a static
``TrackerConfig``; the per-frame step (``tracker.step.build_step``) or
the chunk pipeline (``parallel.pipeline.build_chunk_processor``) runs on the
tracker's device, and host-side post-processing adds the text
annotations (and the optional debug visualizations).  Every pipeline of
the reference and its ``latency_mode`` are ported; 'half' scales the
per-call configs to its half-resolution warped space (``halve_config``),
and diagnostics and snapshots speak in that space, as the reference's.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from lane_tracker_tpu_torch.calib.homography import perspective_grid
from lane_tracker_tpu_torch.device import DEFAULT_DEVICE, entry_device
from lane_tracker_tpu_torch.kernels.resample import (
    ResampleGrid,
    bilinear_gather,
    slot_remap,
)
from lane_tracker_tpu_torch.parallel.pipeline import build_chunk_processor
from lane_tracker_tpu_torch.render.split import triple_split_view
from lane_tracker_tpu_torch.render.text import draw_text
from lane_tracker_tpu_torch.render.viz import search_visualization
from lane_tracker_tpu_torch.tracker.config import (
    FilterConfig,
    SearchConfig,
    TrackerConfig,
    ValidityConfig,
    halve_config,
)
from lane_tracker_tpu_torch.tracker.state import (
    TrackerState,
    state_from_npz,
    state_to_npz,
)
from lane_tracker_tpu_torch.tracker.step import (
    TrackerParams,
    build_step,
    half_geometry,
    make_initial_state,
)
from lane_tracker_tpu_torch.tracker.upload import Staging, StreamedChunk
from lane_tracker_tpu_torch.utils.profiling import (
    count,
    host_read,
    unit,
)

# process()'s per-frame debug flags, which have no chunked equivalent.
_DEBUG_FLAGS = ("visualize_search", "split_view", "diagnostics")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class LaneTracker:
    """Track the two ego-lane boundary lines across a video stream.

    Args mirror the reference constructor (lane_tracker.py:101-137), plus:
        validity: optional ValidityConfig overriding the committed
            thresholds (PRESETS holds the per-demo-video sets).
        pipeline: 'fast' (default; the reference's exact two-stage
            resample chain, ROI-cropped, with the filter kernels),
            'corridor' ('fast' restricted to the decision corridor plus
            its filter-influence margin, with the per-frame
            ``corridor_ok`` certificate), 'compat' (the full-frame chain
            with the LUT LAB conversion and the unwarped lane mask), or
            one of the reference's opt-in measured approximations: 'half'
            (the whole warped space at half resolution: scaled
            calibration, doubled m/px, px-denominated knobs halved
            automatically) or 'turbo' (LAB-B taken on the undistorted
            band and warped as a channel).
        latency_mode: the two-stage warp by slab reads and one-hot
            contractions (``TrackerParams.with_rowmm``; bit for bit the
            gather; about 380 MB of one-hot tensors on the card).
        device: where the tracker's tensors live, the card unless the
            caller passes ``device="cpu"`` (raises without CUDA).
    """

    def __init__(
        self,
        img_size,
        warped_size,
        cam_matrix,
        dist_coeffs,
        warp_matrices,
        mpp_conversion,
        n_fail=8,
        n_reset=4,
        n_average=2,
        print_frame_count=False,
        validity: ValidityConfig | None = None,
        pipeline: str = "fast",
        latency_mode: bool = False,
        device=DEFAULT_DEVICE,
    ):
        self.device = entry_device(device)
        self.img_size = tuple(int(v) for v in img_size)
        self.warped_size = tuple(int(v) for v in warped_size)
        self.n_fail = int(n_fail)
        self.n_reset = int(n_reset)
        self.n_average = int(n_average)
        self.print_frame_count = bool(print_frame_count)
        self._validity = validity if validity is not None else ValidityConfig()
        self._M = np.asarray(warp_matrices[0], np.float64)
        self.params = TrackerParams.build(
            np.asarray(cam_matrix, np.float64),
            np.asarray(dist_coeffs, np.float64),
            self._M,
            np.asarray(warp_matrices[1], np.float64),
            self.img_size,
            self.warped_size,
            float(mpp_conversion[0]),
            float(mpp_conversion[1]),
            pipeline=pipeline,
            device=self.device,
        )
        if self.params.res_scale == 2:
            # The split view's full-frame warp is the compute space's.
            self._M = half_geometry(self._M, warp_matrices[1],
                                    self.warped_size, 1.0, 1.0)[0]
        if latency_mode:
            self.params = self.params.with_rowmm()
        self._split_grid = None
        # process_chunk's pinned slice buffers and copy stream (the card).
        self._staging: Staging | None = None
        self._state: TrackerState | None = None
        self._prev_state: TrackerState | None = None
        self.counter = 0
        self.success = 0
        self.last_output = None  # StepOutput of the most recent frame

    # -- state management ---------------------------------------------------

    def _ensure_state(self, config: TrackerConfig):
        if self._state is None:
            # params.warped_size is the compute space's ('half' scales it
            # down from the caller's warped_size).
            self._state = make_initial_state(config, self.params.warped_size,
                                             self.device)

    def reset(self):
        """Forget all tracking state (fresh stream)."""
        self._state = None
        self.counter = 0
        self.success = 0

    def save_state(self, path):
        """Snapshot tracker state for checkpoint/resume (the reference's
        ``.npz`` keys: either package loads it)."""
        if self._state is None:
            raise RuntimeError("no state to save; process a frame first")
        state_to_npz(self._state, path)

    def load_state(self, path):
        self._state = state_from_npz(path, self.device)
        self.counter = int(self._state.counter)
        self.success = int(self._state.success)

    # -- the public API -----------------------------------------------------

    def get_success_ratio(self):
        """Fraction of processed frames with valid lane lines
        (lane_tracker.py:178-181)."""
        return self.success / self.counter, self.success, self.counter

    def _config_from_kwargs(
        self,
        ksize_r,
        C_r,
        ksize_b,
        C_b,
        filter_type,
        mask_noise,
        noise_thresh,
        ksize_noise,
        C_noise,
        window_width,
        window_height,
        search_range,
        mu,
        no_success_limit,
        start_slice,
        ignore_sides,
        ignore_bottom,
        bandwidth,
        partial,
        n_tries,
    ) -> TrackerConfig:
        cfg = TrackerConfig(
            filter=FilterConfig(
                filter_type=filter_type,
                ksize_r=int(ksize_r),
                C_r=int(C_r),
                ksize_b=int(ksize_b),
                C_b=int(C_b),
                mask_noise=bool(mask_noise),
                noise_thresh=int(noise_thresh),
                ksize_noise=int(ksize_noise),
                C_noise=int(C_noise),
            ),
            search=SearchConfig(
                window_width=int(window_width),
                window_height=int(window_height),
                search_range=int(search_range),
                mu=float(mu),
                no_success_limit=int(no_success_limit),
                start_slice=float(start_slice),
                ignore_sides=int(ignore_sides),
                ignore_bottom=int(ignore_bottom),
                bandwidth=int(bandwidth),
                partial=float(partial),
            ),
            validity=self._validity,
            n_tries=int(n_tries),
            n_fail=self.n_fail,
            n_reset=self.n_reset,
            n_average=self.n_average,
        )
        if self.params.res_scale == 2:
            # 'half': the caller speaks full-resolution px; the compute
            # space is half-resolution, so px-denominated knobs halve.
            cfg = halve_config(cfg)
        return cfg

    def _narrate_validity(self, lc, rc, n_left, n_right, v):
        """Print the reference's exact check_validity diagnostics message
        (lane_tracker.py:596-627), recomputed in closed form from the
        fitted coefficients, in the compute space ('half''s is scaled
        down)."""
        ws = self.params.warped_size
        W = ws[0] if v.y_eval_from_width else ws[1]
        nmin = min(int(n_left), int(n_right))
        y1, y2, y3 = W - 1, W - int(nmin * 0.35), W - int(nmin * 0.75)
        x1, x2, x3 = (
            abs(np.polyval(lc, y) - np.polyval(rc, y)) for y in (y1, y2, y3)
        )
        dist = (
            "x1_diff == {:.2f}, x2_diff == {:.2f}, x3_diff == {:.2f} "
            "(min_dist_y1 == {}, max_dist_y1 == {}, min_dist_y2 == {}, "
            "max_dist_y2 == {}, min_dist_y3 == {}, max_dist_y3 == {})".format(
                x1, x2, x3, v.min_dist_y1, v.max_dist_y1, v.min_dist_y2,
                v.max_dist_y2, v.min_dist_y3, v.max_dist_y3,
            )
        )
        if (
            (x1 < v.min_dist_y1) | (x1 > v.max_dist_y1)
            | (x2 < v.min_dist_y2) | (x2 > v.max_dist_y2)
            | (x3 < v.min_dist_y3) | (x3 > v.max_dist_y3)
        ):
            print(
                "No valid lane lines found, violated distance criterion: "
                + dist
            )
            return
        d = lambda c, y: 2 * c[0] * y + c[1]  # noqa: E731
        norm1 = abs(d(lc, y1) - d(rc, y1))
        norm2 = abs(d(lc, y3) - d(rc, y3))
        tang = "norm1 == {:.3f}, norm2 == {:.3f} (thresh == {})".format(
            norm1, norm2, v.tangent_thresh
        )
        if (norm1 >= v.tangent_thresh) | (norm2 >= v.tangent_thresh):
            print(
                "No valid lane lines found, violated tangent criterion: "
                + tang + ". Distance: " + dist
            )
        else:
            print(
                "Valid lane lines found. Tangents: " + tang
                + ". Distance: " + dist
            )

    def _print_diagnostics(self, out, config):
        """The reference's per-attempt diagnostics narration, reproduced
        print for print (lane_tracker.py:267, 441-447, 461, 596-627,
        1062-1143): search mode, pixel outcome and the validity criterion
        message for EACH attempt that ran, then the attempt verdict."""
        mode = "band" if int(out.search_mode) else "sliding window"
        n_ran = int(out.n_attempts)
        attempts = [(
            bool(out.a1_detected), bool(out.a1_valid),
            _host(out.a1_left_coeffs).astype(float),
            _host(out.a1_right_coeffs).astype(float),
            int(out.a1_n_left), int(out.a1_n_right),
        )]
        if n_ran >= 2:
            attempts.append((
                bool(out.detected), bool(out.valid),
                _host(out.left_coeffs).astype(float),
                _host(out.right_coeffs).astype(float),
                int(out.n_points_left), int(out.n_points_right),
            ))
        for i, (detected, valid, lc, rc, nl, nr) in enumerate(attempts):
            print(f"Using {mode} search.")
            print("Lane pixels found." if detected else "No lane pixels found.")
            if detected:
                self._narrate_validity(lc, rc, nl, nr, config.validity)
            if valid:
                which = "first" if i == 0 else "second"
                print(f"Success at {which} attempt!")
            elif i == 0 and n_ran >= 2:
                print("No success at first attempt, now trying second.")
        if not bool(out.valid):
            print("No success after all attempts.")

    def _warp_grid(self) -> ResampleGrid:
        """The bird's-eye warp of the full frame ('compat''s grid_warp;
        built once for the other pipelines), for the split view."""
        if self.params.grid_warp is not None:
            return self.params.grid_warp
        if self._split_grid is None:
            self._split_grid = ResampleGrid.from_remapped(slot_remap(
                perspective_grid(self._M, self.img_size,
                                 self.params.warped_size))).to(self.device)
        return self._split_grid

    def process(
        self,
        img,
        ksize_r=15,
        C_r=8,
        ksize_b=35,
        C_b=5,
        filter_type="bilateral",
        mask_noise=False,
        noise_thresh=140,
        ksize_noise=65,
        C_noise=10,
        window_width=30,
        window_height=40,
        search_range=20,
        mu=0.1,
        no_success_limit=8,
        start_slice=0.25,
        ignore_sides=360,
        ignore_bottom=30,
        bandwidth=25,
        partial=1.0,
        n_tries=2,
        visualize_search=False,
        split_view=False,
        diagnostics=False,
    ):
        """Process one RGB uint8 frame; returns the annotated frame as a
        numpy array.

        Mirrors the reference's keyword surface and defaults exactly
        (lane_tracker.py:876-900; per-argument docs there apply verbatim).
        With ``visualize_search`` returns (frame, search_visualization);
        with ``split_view`` returns the 3-pane composite.
        """
        config = self._config_from_kwargs(
            ksize_r, C_r, ksize_b, C_b, filter_type, mask_noise, noise_thresh,
            ksize_noise, C_noise, window_width, window_height, search_range,
            mu, no_success_limit, start_slice, ignore_sides, ignore_bottom,
            bandwidth, partial, n_tries,
        )
        self._ensure_state(config)
        step = build_step(config)
        frame = torch.tensor(np.asarray(img, dtype=np.uint8),
                             device=self.device)
        self._prev_state = self._state
        self._state, out = step(self._state, frame, self.params)
        self.last_output = out
        self.counter += 1
        if bool(out.valid):
            self.success += 1

        if diagnostics:
            self._print_diagnostics(out, config)

        annotated = _host(out.overlay).copy()
        if int(out.render_mode) == 0:
            draw_text(
                annotated, f"Curve Radius: {int(out.radius)} m", (20, 35)
            )
            draw_text(
                annotated, f"Eccentricity: {float(out.ecc):.2f} m", (20, 70)
            )
            if self.print_frame_count:
                draw_text(annotated, f"Frame: {self.counter - 1}", (20, 105))
        else:
            draw_text(annotated, "Lane Line Detection Failed", (20, 35))
            if self.print_frame_count:
                draw_text(annotated, f"Frame: {self.counter - 1}", (20, 70))

        if visualize_search or split_view:
            viz = search_visualization(self, frame, config, out)
            if visualize_search:
                return annotated, viz
            # The reference always pre-warps the raw frame for the split
            # view (lane_tracker.py:1035).
            warped = _host(bilinear_gather(frame[None], self._warp_grid())[0])
            return triple_split_view([annotated, warped, viz])
        return annotated

    def process_chunk(
        self,
        frames,
        with_overlay=True,
        second_attempt="two_phase",
        **kwargs,
    ):
        """Throughput API: process a (T, H, W, 3) uint8 chunk of consecutive
        frames through ``parallel.pipeline.build_chunk_processor``'s
        processor for the config.

        Same keyword surface and semantics as :meth:`process` (minus the
        per-frame debug flags ``visualize_search``/``split_view``/
        ``diagnostics``): the front half runs once on the whole batch, the
        back half per frame, the overlays batched.

        ``second_attempt`` selects the fallback schedule ('two_phase',
        'cond' or 'hoist'; all three give identical outputs).

        On the card the frames reach the device in pinned slices on a
        copy stream, and each slice's warp waits only for its own copy
        (``tracker.upload``); on the CPU they are copied whole.

        Returns the chunk's ``StepOutput`` as tensors on the tracker's
        device with a leading T axis (``overlay`` is None when
        ``with_overlay=False``).  Text annotations are NOT burned in;
        render them from the returned radius/ecc/render_mode arrays if
        needed (process_video.py does).
        """
        # The chunk API's tracking defaults ARE process()'s defaults —
        # derive them from its signature so they cannot diverge.
        sig = {
            name: p.default
            for name, p in inspect.signature(self.process).parameters.items()
            if p.default is not inspect.Parameter.empty
            and name not in _DEBUG_FLAGS
        }
        unknown = set(kwargs) - set(sig)
        if unknown:
            raise TypeError(f"unknown process_chunk kwargs: {sorted(unknown)}")
        sig.update(kwargs)
        config = self._config_from_kwargs(**sig)
        self._ensure_state(config)
        frames = np.asarray(frames, dtype=np.uint8)
        if frames.ndim != 4:
            raise ValueError("process_chunk expects a (T, H, W, 3) batch")
        self._prev_state = self._state
        step = build_chunk_processor(config, with_overlay=bool(with_overlay),
                                     second_attempt=str(second_attempt))
        if self.device.type == "cuda" and self._staging is None:
            self._staging = Staging(self.device)
        with unit("lt.chunk", frames.shape[0]):
            frames = StreamedChunk(frames, self.device, self._staging)
            self._state, outs = step(self._state, frames, self.params)
            if self.params.col_roi is None:
                valid = _host(host_read(outs.valid))
            else:
                # 'corridor': the certificate rides the same read.
                valid, certified = _host(host_read(
                    torch.stack([outs.valid, outs.corridor_ok])))
                count("lt.corridor.frames", valid.shape[0])
                count("lt.corridor.uncertified", int((~certified).sum()))
        self.counter += int(valid.shape[0])
        self.success += int(valid.sum())
        self.last_output = type(outs)(
            *(None if x is None else x[-1] for x in outs))
        return outs
