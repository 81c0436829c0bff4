"""Set-up, the measured window, the traced slice and the check of one run.

A driver's ``setup(config, traffic, seed, device, control=False)`` returns
a session with

* ``request(i) -> Output``   one unit of the closed loop (a posterior
                             request, a fit call), ended by a synchronize;
* ``release()``              drops the program's state;
* ``check(kept) -> (numbers, problem)``  runs the reference over the kept
                             outputs and returns the compared numbers and
                             the problem's sizes that the work counts read;

and the driver module a ``work(problem, output)`` that gives the least
seconds of an output's parts, which the roofline readers take.

The window runs requests back to back for ``seconds``; every request that
starts inside it is finished and counted.  A reservoir drawn from the seed
keeps ``check_outputs`` of the window's outputs for the check.
"""
from __future__ import annotations

import dataclasses
import gc
import random
import sys
import time
import traceback

import torch


@dataclasses.dataclass
class Output:
    key: int            # the request's generator seed
    value: object       # what the timed path returned
    iters: list         # CG iterations: one per solve of the request
    units: int          # requests or optimizer steps it completed


@dataclasses.dataclass
class Window:
    wall_s: float
    latencies_s: list
    units: int
    attempted: int
    failed: int
    next_index: int
    iters: list         # CG iterations of every solve in the window


@dataclasses.dataclass
class Trace:
    """One profiled slice of requests after the window."""
    requests: list                  # the slice's Outputs
    device: list                    # (name, start_us, end_us) per device op
    host: list                      # (name, start_us, end_us) per host op
    span: tuple                     # the slice in the profiler's time base

    @property
    def window_s(self) -> float:
        """The slice's length in the profiler's time base."""
        return (self.span[1] - self.span[0]) * 1e-6

    def kernel_s(self, names) -> float:
        """Device seconds of the ops whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names)) * 1e-6

    def busy_intervals(self) -> list:
        lo, hi = self.span
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6


@dataclasses.dataclass
class Run:
    cell: object
    seed: int
    setup_s: float
    window: Window
    peak_bytes: int            # the window's peak
    process_peak_bytes: int    # the process's peak when the window closed
    launches: int              # kernel launches in the window
    trace: Trace | None
    problem: dict
    checks: dict


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(session, seconds: float, seed: int, keep: int, device):
    """Closed loop for ``seconds``; returns (Window, kept outputs)."""
    pick = random.Random(seed)
    kept, lat, iters = [], [], []
    units = attempted = failed = i = 0
    sync(device)
    t0 = end = time.perf_counter()
    while end - t0 < seconds:
        start = time.perf_counter()
        attempted += 1
        try:
            out = session.request(i)
        except Exception:   # a failed request is counted and reported
            failed += 1
            traceback.print_exc(file=sys.stderr)
            out = None
        end = time.perf_counter()
        lat.append(end - start)
        if out is not None:
            units += out.units
            iters.extend(out.iters)
            if len(kept) < keep:
                kept.append(out)
            else:
                j = pick.randrange(i + 1)
                if j < keep:
                    kept[j] = out
        i += 1
    return Window(end - t0, lat, units, attempted, failed, i, iters), kept


def traced_slice(session, start: int, n: int, device) -> Trace:
    """Profile ``n`` requests from index ``start`` (host and device ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    outs = []
    sync(device)
    with profile(activities=acts) as prof:
        with record_function("perfbench.slice"):
            for j in range(n):
                with record_function("perfbench.request"):
                    out = session.request(start + j)
                out.value = None    # the slice is timed, not checked
                outs.append(out)
            sync(device)
    dev_ops, host_ops, span = [], [], None
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # record_function ranges are mirrored onto the device timeline
            # as annotations; they are not device work.
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("perfbench.")):
                dev_ops.append(row)
        else:
            host_ops.append(row)
            if e.name == "perfbench.slice":
                span = row[1:]
    return Trace(outs, dev_ops, host_ops, span)


def breakdown(trace: Trace) -> dict:
    """The ten device ops that took most time, and the ten longest idle
    gaps named by the innermost host op under their midpoint."""
    per = {}
    for name, s, e in trace.device:
        per[name] = per.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = trace.span
    gaps, last = [], lo
    for s, e in trace.busy_intervals():
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if hi > last:
        gaps.append((last, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        under = [h for h in trace.host if h[1] <= mid <= h[2]]
        inner = min(under, key=lambda h: h[2] - h[1])[0] if under else "idle"
        named.append([inner[:80], (e - s) * 1e-6])
    return {"device_ops": [[n[:80], t] for n, t in ops], "idle_gaps": named}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False) -> Run:
    """Set up, measure, optionally trace, then check one run of ``cell``."""
    from repro_torch.kernels import dispatch

    t0 = time.perf_counter()
    session = cell.driver.setup(cell.config, cell.traffic, seed, device,
                                control=control)
    sync(device)
    setup_s = time.perf_counter() - t0
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    dispatch.reset_launch_counts()
    window, kept = run_window(session, seconds, seed,
                              int(cell.traffic.get("check_outputs", 1)), device)
    launches = sum(dispatch.launch_counts().values())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rec = None
    if trace:
        rec = traced_slice(session, window.next_index,
                           int(cell.traffic["trace_requests"]), device)
    session.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, problem = session.check(kept)
    return Run(cell, seed, setup_s, window, peak, max(peak, setup_peak),
               launches, rec, problem, checks)
