"""One run of one cell: set-up, warm-up, the window or the traced stretch,
then the comparison with the plain reference.

``main`` is the command (benchmark/run.py); ``run_cell`` is the run
itself, which the tests drive on the CPU at small sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import pathlib
import sys
import time

from benchmark import cell, check, window

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that no run may have imported once its window
# has closed: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "lane_tracker_tpu")
GIB = 2.0 ** 30


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Phases:
    """Seconds by phase, for the cost line."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t)


def _sync(device):
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _state(x, make_initial):
    """A record's state as a dict of arrays: ``np.savez`` bytes, a dict,
    or None for the fresh state."""
    from benchmark import reference

    if x is None:
        return make_initial()
    if isinstance(x, bytes):
        return reference.state_from_npz_bytes(x)
    return x


def reference_check(records, cfg: dict, root: pathlib.Path, device,
                    phases: Phases, params=None) -> dict:
    """Run the reference over every checked record; the combined
    numbers."""
    import torch

    from benchmark import reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phases("reference"):
        config = reference.tracker_config(cfg["tracker"])
        if params is None:
            params = reference.build_params(root / cfg["calibration"],
                                            cfg["pipeline"], device)
        H = params.warped_size[1]
        parts = []
        for unit in records:
            for rec in unit:
                start = _state(rec["start"], lambda: reference.initial_state(
                    config, params, device))
                end, outs = reference.run_chunk(
                    start, rec["frames"], params, config,
                    with_overlay=bool(cfg["with_overlay"]))
                prog_end = (None if rec["end"] is None
                            else _state(rec["end"], None))
                parts.append(check.compare_stream(rec["outs"], outs,
                                                  prog_end, end, H))
                del outs
    return check.combine(parts)


def _kernel_launches(device):
    if device.type != "cuda":
        return None
    from lane_tracker_tpu_torch.kernels.filter_stage import kernel_launches

    return kernel_launches()


def traced_stretch(entry, units: int, device, root: pathlib.Path):
    """Profile ``units`` chunks or steps: (events, frames, seconds,
    hand-kernel launches the library counted, or None off the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    sync = _sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync()
    count0 = _kernel_launches(device)
    frames = 0
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            frames += entry.unit()
        sync()
        seconds = time.perf_counter() - t0
    count1 = _kernel_launches(device)
    events = trace.events_from_profile(
        prof, root / "build" / "benchmark" / "trace.json")
    del prof
    if device.type == "cuda":
        torch.cuda.empty_cache()
    counted = None if count0 is None else count1 - count0
    return events, frames, seconds, counted


def run_cell(root: pathlib.Path, bench: dict, name: str, seed: int,
             seconds: float, traced: bool, device, start: float,
             control: str | None = None, config_override: dict | None = None,
             mix_override: dict | None = None,
             phases: Phases | None = None) -> dict:
    """One run of cell ``name`` on ``device``: returns {"result": the
    result's object, "cost": seconds by phase and the pool's size,
    "lines": the comparison's lines}.  ``control`` ('bfloat16') puts the
    reference, its warp and LAB-B sums in that type, in the program's
    place.  ``config_override`` replaces top-level keys of the cell's
    configuration, ``mix_override`` of its mix (the tests' small
    sizes).  ``phases`` holds seconds already spent (the imports)."""
    phases = phases or Phases()
    with phases("import"):
        import torch

        import lane_tracker_tpu_torch  # noqa: F401

    wl = cell.workload(bench, name)
    cfg = cell.config(HERE, wl["config"])
    cfg.update(config_override or {})
    mix = cell.mix(HERE, wl["traffic"])
    mix.update(mix_override or {})
    sync = _sync(device)
    if device.type == "cuda":
        with phases("library"):
            from lane_tracker_tpu_torch.kernels.build import load_library

            load_library()
    gen = cell.generator(HERE, mix)
    entry = cell.entry(HERE, cfg).Entry(cfg, mix, seed, device, root, gen,
                                       phases)
    pool = {"pool_frames": entry.pool_frames, "pool_bytes": entry.pool_bytes}
    if control is not None:
        from benchmark import control as control_mod

        with phases("params"):
            control_mod.substitute(entry, cfg, root, device,
                                   getattr(torch, control))
    sync()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    with phases("warm_up"):
        entry.warm_up()
        sync()
    setup_s = time.perf_counter() - start
    e2e = {m["name"]: m for m in cell.metrics(bench, "end_to_end", name)}
    metrics, device_info, breakdown = {}, {}, None
    ref_params = None
    with phases("window"):
        if traced:
            events, frames, win_s, counted = traced_stretch(
                entry, int(cfg["trace_units"]), device, root)
            attempted = frames
        else:
            w = window.run_window(entry.unit, seconds, sync)
            attempted = w["frames"]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if traced:
        from benchmark import reference, trace

        seen = len(trace.hand_kernel_events(events))
        if counted is not None and seen != counted:
            raise TraceIncomplete(
                f"the trace holds {seen} of the {counted} filter-kernel "
                f"launches the library counted over the stretch")
        ref_params = reference.build_params(root / cfg["calibration"],
                                            cfg["pipeline"], device)
        cols = ref_params.col_comp or (0, ref_params.warped_size[0])
        shapes = {"frames_per_call": entry.frames_per_call,
                  "H": ref_params.warped_size[1], "W": cols[1] - cols[0],
                  "raw_rows": ref_params.raw_roi[1] - ref_params.raw_roi[0],
                  "raw_width": ref_params.img_size[0],
                  "filter": cfg["tracker"]["filter"],
                  "second_open_k": 5}
        reading = trace.TraceReading(events, frames, win_s, shapes)
        t_lo = min(e["ts"] for e in events if "ts" in e and "dur" in e)
        t_hi = max(e["ts"] + e["dur"] for e in events
                   if "ts" in e and "dur" in e)
        breakdown = trace.breakdown(events, t_lo, t_hi)
        del events
        for mname, mod in cell.readers(HERE, bench, name).items():
            value = mod.read(reading)
            if value is not None:
                metrics[mname] = {"value": value, "unit": mod.UNIT}
        device_info = {"busy_s": reading.busy_s, "window_s": win_s}
    else:
        values = {"frames_per_s": window.frames_per_s(w),
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for mname, m in e2e.items():
            metrics[mname] = {"value": values[mname], "unit": m["unit"]}
    with phases("records"):
        records = entry.records()
        entry.release()
        del entry
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    second = sum(int((rec["outs"]["n_attempts"] > 1).sum())
                 for unit in records for rec in unit)
    numbers = reference_check(records, cfg, root, device, phases,
                              ref_params)
    del records
    correct, table = check.judge(numbers, cfg["check"]["limits"])
    from benchmark.card import card

    info = card(device)
    result = {"correct": correct, "attempted": int(attempted), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type, "kind": info["name"],
                         "count": int(wl["chips"]),
                         "memory_peak_bytes": int(peak), **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = table
    cost = {f"{k}_s": v for k, v in phases.seconds.items()}
    cost.update(setup_s=setup_s, second_attempt_frames_checked=second,
                unit_seconds=None if traced else w["unit_seconds"], **pool)
    lines = [f"{k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in table.items()]
    return {"result": result, "cost": cost, "lines": lines,
            "power_limit": info["power_limit"]}


class TraceIncomplete(RuntimeError):
    pass


def parse(argv):
    ap = argparse.ArgumentParser(
        prog="benchmark/run.py",
        description="Run one cell of the lane tracker's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bfloat16",), default=None,
                    help="put the reference, its float sums in this type, "
                    "in the program's place (the control of the check)")
    return ap.parse_args(argv)


def main(argv, start: float) -> int:
    args = parse(argv)
    bench = cell.load_benchmark(ROOT)
    wl = cell.workload(bench, args.workload)
    phases = Phases()
    phases.seconds["import"] = time.perf_counter() - start
    with phases("import"):
        import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < int(wl["chips"]):
        log(f"{wl['name']} needs {wl['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    try:
        with phases("import"):
            import lane_tracker_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"the program is not in this checkout: {exc}")
        return 2
    device = torch.device("cuda", 0)
    try:
        out = run_cell(ROOT, bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), device, start, control=args.control,
                       phases=phases)
    except TraceIncomplete as exc:
        log(f"traced run refused: {exc}")
        return 4
    found = forbidden_modules()
    if found:
        log(f"imported, and must not be: {found}")
        return 3
    cost = dict(out["cost"], power_limit=out["power_limit"])
    print(json.dumps({"cost": cost}))
    for line in out["lines"]:
        log(line)
    print(json.dumps(out["result"]), flush=True)
    return 0
