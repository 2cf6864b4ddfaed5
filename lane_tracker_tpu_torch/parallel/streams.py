"""Multi-stream fleet serving: streams sharded over a device list.

Port of lane_tracker_tpu/parallel/streams.py.  Production serving runs
many dashcam streams at once; each stream carries its own TrackerState
and the whole fleet steps in lockstep chunks:

    states:  one TrackerState per device, each with a leading (S_local,)
             axis (``parallel.mesh.shard_streams``)
    frames:  (S, T, Hc, Wc, 3) uint8, stream shard i on device i

For each device's shard, a fleet step flattens the local (S_local, T)
frames into ONE (S_local * T) batch for the stateless front half, so the
filter's hand kernels launch once a step on all of them, as in
single-stream serving; only the O(H)-per-frame back half runs per stream,
and it runs batched over the streams (``scan_streams``: on the card one
launch of the back-half kernel, a thread block a stream, scans every
stream's T frames; on the CPU, at each time step one ``torch.func.vmap``
of ``back_half``, as the reference ``vmap``s each stream's ``lax.scan``).
Streams are independent; the only cross-device step is summing the
metrics.  One host thread queues every shard's work, shard after shard,
so a shard's work starts only once the shard before it is queued.

The second attempt's schedules are the reference's two: 'two_phase' scans
attempt 1 over all local streams, reads once per shard and step whether
every frame was valid, and only if not runs the batched 'neighborhood'
filter on the shard's whole flat batch and rescans every local stream
from the step's original states; 'hoist' filters every frame up front
and scans once.  Both give identical outputs.  'cond' (a host read per
frame) is not a fleet schedule.  ``StreamFleet(second_attempt='auto')``
switches between the two on the observed share of poisoned steps.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from lane_tracker_tpu_torch.kernels import back_half as back_half_kernel
from lane_tracker_tpu_torch.parallel.mesh import (
    map_tensors,
    replicate,
    shard_streams,
    stream_mesh,
)
from lane_tracker_tpu_torch.parallel.pipeline import _stack
from lane_tracker_tpu_torch.tracker.config import TrackerConfig
from lane_tracker_tpu_torch.tracker.state import TrackerState
from lane_tracker_tpu_torch.tracker.step import (
    FrontArtifacts,
    RenderMeta,
    StepOutput,
    TrackerParams,
    back_half,
    front_artifacts_batch,
    has_second_attempt,
    make_initial_state,
    render_frame,
    second_attempt_artifacts_batch,
)
from lane_tracker_tpu_torch.utils.profiling import (
    count,
    host_read,
    span,
    unit,
)

SCHEDULES = ("two_phase", "hoist")


def _split(tree, S: int, T: int):
    """(S * T, ...) leaves as (S, T, ...)."""
    return map_tensors(lambda x: x.reshape((S, T) + x.shape[1:]), tree)


def _merge(tree):
    """(S, T, ...) leaves as (S * T, ...)."""
    return map_tensors(lambda x: x.reshape((-1,) + x.shape[2:]), tree)


def scan_streams(states: TrackerState, arts: FrontArtifacts,
                 params: TrackerParams, config: TrackerConfig):
    """Each stream's back half over its T frames, the streams batched.

    ``states`` holds S streams' states (a leading (S,) axis), ``arts``
    their (S, T, ...) front artifacts.  The fleet calls it with hoisted
    attempt-2 artifacts or a config with one attempt, so no frame needs a
    host decision: on the card one launch of the back-half kernel scans
    every stream (``kernels.back_half``, a thread block a stream), on the
    CPU the plain twin ``scan_streams_plain``.  Returns (states,
    (StepOutput without the overlay, RenderMeta)) with leading (S, T)
    axes."""
    S, T = arts.pref.packed.shape[:2]
    count("lt.back_half.frames", S * T)
    if back_half_kernel.takes_kernel(arts, config):
        return back_half_kernel.scan(states, arts, params, config)
    return scan_streams_plain(states, arts, params, config)


def scan_streams_plain(states: TrackerState, arts: FrontArtifacts,
                       params: TrackerParams, config: TrackerConfig):
    """The plain twin of the back-half kernel over S streams: at each
    time step one ``torch.func.vmap`` of ``back_half`` runs all S
    streams, so the step's kernel launches are one back half's whatever
    S is.  ``back_half`` reads nothing on the host given hoisted
    attempt-2 artifacts or a config with one attempt, the only ways the
    fleet calls it."""

    def one(st, art):
        st, out, meta = back_half(st, art, params, config)
        return st, tuple(out)[1:], meta  # no overlay: vmap returns tensors

    # No attempt-2 artifacts under two_phase's first scan: in_dims None.
    step = torch.func.vmap(one, in_dims=(0, FrontArtifacts(
        *(None if x is None else 0 for x in arts))))
    T = arts.pref.packed.shape[1]
    outs, metas = [], []
    for t in range(T):
        states, out, meta = step(states,
                                 map_tensors(lambda x: x[:, t], arts))
        outs.append(StepOutput(None, *out))
        metas.append(meta)
    with span("lt.back_half.stack"):
        return states, (_stack(outs, 1), _stack(metas, 1))


def _local_metrics(outs: StepOutput) -> dict:
    i32 = torch.int32
    return {
        "frames": torch.full((), outs.valid.numel(), dtype=i32,
                             device=outs.valid.device),
        "valid_frames": outs.valid.sum().to(i32),
        "detected_frames": outs.detected.sum().to(i32),
        "second_attempts": (outs.n_attempts > 1).sum().to(i32),
    }


@dataclasses.dataclass
class _Shard:
    """One device's part of a fleet step."""

    states: TrackerState
    flat: torch.Tensor  # (S_local * T, Hc, Wc, 3) frames
    arts: FrontArtifacts  # (S_local * T, ...)
    states_out: TrackerState | None = None
    outs: StepOutput | None = None
    metas: RenderMeta | None = None


@functools.lru_cache(maxsize=16)
def build_fleet_processor(config: TrackerConfig, mesh,
                          with_overlay: bool = False,
                          second_attempt: str = "two_phase"):
    """fn: (states, frames, params) -> (states, outs, metrics).

    ``states``: one TrackerState per device of ``mesh`` (a tuple of
    devices, ``parallel.mesh.stream_mesh``), each with a leading
    (S_local,) axis; ``frames``: (S, T, Hc, Wc, 3) uint8 on the host or a
    device; ``params``: one TrackerParams per device
    (``parallel.mesh.replicate``).  ``outs`` is one StepOutput with
    leading (S, T) axes on ``mesh[0]`` (the overlay (S, T, Hc, Wc, 3) with
    ``with_overlay``, else None); ``metrics`` holds ``frames``,
    ``valid_frames``, ``detected_frames`` and ``second_attempts``, int32
    scalars summed over the devices, on ``mesh[0]``.

    second_attempt: 'two_phase' (default) scans attempt 1 only and runs
    the batched fallback on a shard whose step holds a failed frame: free
    in the steady state, but such a step pays the attempt-2 filter for
    the shard's WHOLE local batch.  'hoist' runs the attempt-2 filter on
    every frame up front: every step pays it, failure-dense loads nothing
    more.  Cached per (config, mesh, with_overlay, second_attempt), as
    the reference's jitted processor.
    """
    if second_attempt not in SCHEDULES:
        raise ValueError(f"unknown second_attempt {second_attempt!r}; "
                         f"expected one of {SCHEDULES}")
    mesh = tuple(torch.device(d) for d in mesh)
    hoist = second_attempt == "hoist"
    two_phase = not hoist and has_second_attempt(config)
    cfg1 = dataclasses.replace(config, n_tries=1)

    def fn(states, frames, params):
        if len(states) != len(mesh) or len(params) != len(mesh):
            raise ValueError(f"{len(states)} state shards and {len(params)} "
                             f"params for {len(mesh)} devices")
        shards = []
        with span("lt.upload"):
            pieces = shard_streams(frames, mesh)
        for st, fr, p in zip(states, pieces, params):
            S, T = fr.shape[:2]
            flat = fr.reshape((S * T,) + fr.shape[2:])
            sh = _Shard(st, flat, front_artifacts_batch(
                flat, p, config, hoist_second_attempt=hoist))
            with span("lt.back_half"):
                sh.states_out, (sh.outs, sh.metas) = scan_streams(
                    st, _split(sh.arts, S, T), p,
                    cfg1 if two_phase else config)
            shards.append(sh)
        if two_phase:
            # The host reads come after every shard's attempt-1 scan is
            # queued, so no read holds back a later shard's queueing; the
            # fallback's work is queued shard after shard, as above.
            for sh, p in zip(shards, params):
                if bool(host_read(sh.outs.valid.all())):
                    continue
                count("lt.rescans")
                S, T = sh.outs.valid.shape
                with span("lt.second_attempt"):
                    pref2, iv2 = second_attempt_artifacts_batch(
                        sh.arts.r_chan, sh.arts.b_chan, p)
                full = _split(sh.arts._replace(pref2=pref2, iv_sws2=iv2),
                              S, T)
                with span("lt.back_half"):
                    sh.states_out, (sh.outs, sh.metas) = scan_streams(
                        sh.states, full, p, config)
        if with_overlay:
            for sh, p in zip(shards, params):
                with span("lt.overlay"):
                    ov = render_frame(sh.flat, _merge(sh.metas), p, config)
                sh.outs = sh.outs._replace(
                    overlay=ov.reshape(sh.outs.valid.shape + ov.shape[1:]))
        local = [_local_metrics(sh.outs) for sh in shards]
        metrics = {k: sum(m[k].to(mesh[0]) for m in local) for k in local[0]}
        if len(shards) == 1:
            outs = shards[0].outs
        else:
            outs = StepOutput(*(None if fs[0] is None else torch.cat(
                [x.to(mesh[0]) for x in fs]) for fs in zip(
                    *(sh.outs for sh in shards))))
        return tuple(sh.states_out for sh in shards), outs, metrics

    return fn


class StreamFleet:
    """S concurrent streams, stepped in lockstep over a device list."""

    def __init__(
        self,
        params: TrackerParams,
        config: TrackerConfig,
        n_streams: int,
        mesh=None,
        with_overlay: bool = False,
        second_attempt: str = "two_phase",
        auto_crossover: float = 0.81,
        auto_hysteresis: float = 0.05,
        auto_alpha: float = 0.25,
    ):
        """mesh: the devices (``parallel.mesh.stream_mesh``); None means
        every CUDA device, and raises without CUDA.  second_attempt:
        'two_phase', 'hoist', or 'auto'.

        'auto' tracks the observed poisoned-step probability: the
        fraction of steps where ANY device's local batch holds an
        attempt-1 failure.  The devices step in lockstep, so one poisoned
        shard makes the whole fleet's step pay two_phase's fallback,
        which is why the indicator is any-over-devices, not the mean.
        The controller keeps a host-side EMA of the per-step indicator
        and flips the schedule past the crossover (the reference measured
        0.81 on its chips); hysteresis keeps a load sitting on the
        boundary from thrashing.  Both schedules give identical outputs,
        so a flip changes only cost.
        """
        self.params = params
        self.config = config
        self.n_streams = int(n_streams)
        self.mesh = (stream_mesh() if mesh is None
                     else stream_mesh(devices=mesh))
        n_dev = len(self.mesh)
        if self.n_streams % n_dev:
            raise ValueError(
                f"n_streams={n_streams} must divide over {n_dev} devices")
        self.with_overlay = with_overlay
        if second_attempt not in ("two_phase", "hoist", "auto"):
            raise ValueError(
                f"unknown second_attempt {second_attempt!r}; expected "
                "'two_phase', 'hoist', or 'auto'")
        self._mode = second_attempt
        self.schedule = ("two_phase" if second_attempt == "auto"
                         else second_attempt)
        self._auto_crossover = float(auto_crossover)
        self._auto_hysteresis = float(auto_hysteresis)
        self._auto_alpha = float(auto_alpha)
        self.poison_ema = 0.0
        self._fn = build_fleet_processor(config, self.mesh, with_overlay,
                                         second_attempt=self.schedule)
        s_local = self.n_streams // n_dev
        self.states = tuple(
            TrackerState(*(x.expand(s_local, *x.shape).contiguous()
                           for x in make_initial_state(
                               config, params.warped_size, d)))
            for d in self.mesh)
        self.params_device = replicate(params, self.mesh)

    def step(self, frames):
        """frames: (S, T, Hc, Wc, 3) uint8 (host or device).  Returns
        (outs, metrics) as ``build_fleet_processor``'s function."""
        if frames.shape[0] != self.n_streams:
            raise ValueError(f"frames for {frames.shape[0]} streams, the "
                             f"fleet has {self.n_streams}")
        with unit("lt.fleet_step", frames.shape[0] * frames.shape[1]):
            if self.schedule == "hoist":
                count("lt.fleet.hoist_steps")
            self.states, outs, metrics = self._fn(
                self.states, frames, self.params_device)
            if self._mode == "auto":
                self._auto_update(outs)
        return outs, metrics

    def _auto_update(self, outs):
        """EMA the observed poisoned-step rate and flip the schedule at
        the crossover (see __init__).  a1_valid is the attempt-1 outcome
        under BOTH schedules, so the observation is schedule-independent;
        the read is one of S*T bools per step."""
        poisoned = float(not bool(host_read(
            torch.as_tensor(outs.a1_valid).all())))
        self.poison_ema += self._auto_alpha * (poisoned - self.poison_ema)
        want = self.schedule
        if (self.schedule == "two_phase"
                and self.poison_ema > self._auto_crossover):
            want = "hoist"
        elif (self.schedule == "hoist"
              and self.poison_ema
              < self._auto_crossover - self._auto_hysteresis):
            want = "two_phase"
        if want != self.schedule:
            count("lt.fleet.schedule_flips")
            self.schedule = want
            self._fn = build_fleet_processor(
                self.config, self.mesh, self.with_overlay,
                second_attempt=want)
