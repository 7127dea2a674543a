"""One run of one cell: set-up, a closed-loop window of requests, the
check against the plain reference, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up generates the cell's inputs from the seed, loads them into the
port, draws every request's traffic and warms the entry up; ``setup_s``
runs from process start to the first timed request.  The window is one
client sending each request when the last one has finished (synchronized
with the device), until ``--seconds`` have passed; the last request runs to
its end.  With ``--trace 1`` the last ``TRACE_S`` seconds of the window run
under ``torch.profiler`` (the trace runs on past the window's end until
it has lasted that long), and the line carries
the per-layer metrics and a ``breakdown`` instead of the end-to-end ones.
After the window a seeded sample of the answers is compared with the plain
reference under ``portbench/reference``."""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from portbench import guard, plugins
from portbench import trace as tracing

TRACE_S = 4.0    # seconds of the window traced in a --trace 1 run


class NoDevice(RuntimeError):
    pass


class Run:
    """What the metrics' readers see of one run."""

    def __init__(self, cell: str, unit: str):
        self.cell, self.unit = cell, unit
        self.setup_s = 0.0
        self.graph_build_s = 0.0
        self.window_s = 0.0
        self.latencies_s: List[float] = []
        self.untraced_s: Optional[float] = None   # the part of the window before the trace
        self.untraced_counts: Dict[str, float] = {}
        self.traced_counts: Dict[str, float] = {}
        self.trace: Optional[tracing.Summary] = None
        self.power_limit = ""
        self.device_kind = ""


class Context:
    """What an entry's ``check`` needs besides the samples."""

    def __init__(self, cell, seed, device, builder, inputs, requests):
        self.seed, self.device = seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.builder, self.inputs, self.requests = builder, inputs, requests


class Reservoir:
    """A uniform sample, drawn from the seed, of ``k`` of the window's
    answers (reservoir sampling: the answers are held, not copied)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 2])
        self.items: List[Any] = []
        self.seen = 0

    def offer(self, item):
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@contextlib.contextmanager
def kernel_build_timed(parts: Dict[str, float]):
    """Times the port's kernel builds (``kernels/build.py``
    ``compile_source``: ``nvcc`` on a checkout's first run, a look for the
    built library after) into ``parts["kernel_build"]``, so set-up reports
    the compile apart from the rest of the warm-up that holds it."""
    from repro_torch.kernels import build

    real = build.compile_source
    spent = [0.0]

    def timed(stem):
        t0 = time.perf_counter()
        try:
            return real(stem)
        finally:
            spent[0] += time.perf_counter() - t0
    build.compile_source = timed
    try:
        yield
    finally:
        build.compile_source = real
        parts["kernel_build"] = spent[0]


def _add(into: Dict[str, float], counts: Dict[str, float]):
    for k, v in counts.items():
        into[k] = into.get(k, 0) + v


def smi(fields: str) -> str:
    """``nvidia-smi``'s reading of ``fields`` for the first card."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30,
                             check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.splitlines()[0] if out else "not read"


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _device(chips: int, device):
    import torch

    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} are present")
    return "cuda"


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
             t_process: Optional[float] = None, device=None, control: Optional[str] = None,
             samples: Optional[int] = None, requests_max: Optional[int] = None) -> dict:
    """One run; returns the result line as a dict (``correct`` and the
    rest).  ``device`` other than None skips the look for a card (the CPU
    tests); ``control``, ``samples`` and ``requests_max`` serve the control
    runs (``control.py``): the check then also reads the control."""
    import torch

    t_process = time.perf_counter() if t_process is None else t_process
    cell = plugins.load_cell(root, workload)
    device = _device(cell.chips, device)
    cuda = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    builder = plugins.load_module(root, "graphs", cell.config["builder"])
    entry = plugins.load_module(root, "entries", cell.traffic["entry"])
    run = Run(cell.name, entry.UNIT)

    # -- set-up -------------------------------------------------------------
    parts = {"start": time.perf_counter() - t_process}
    clock = time.perf_counter()

    def part(name):
        nonlocal clock
        sync()
        now = time.perf_counter()
        parts[name] = now - clock
        clock = now

    inputs = builder.generate(cell.config, seed, device)
    part("generate")
    requests = entry.draw(cell.traffic, cell.config, inputs, seed, device)
    part("draw")
    # the builder lets go of what the program and the check no longer need
    system, run.graph_build_s = builder.load(cell.config, inputs, device, sync)
    part("load")
    driver = entry.Driver(system, requests, cell.traffic, cell.config, device)
    with kernel_build_timed(parts):
        driver.warm()
    if trace:
        tracing.warm_profiler(device)
    part("warm")
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_process

    # -- the window -----------------------------------------------------------
    k = int(cell.traffic.get("check_sample", 2) if samples is None else samples)
    reservoir = Reservoir(k, seed)
    tracer = tracing.Tracer(device) if trace else None
    trace_s = min(TRACE_S, seconds / 2)
    t_traced = 0.0
    attempted = failed = 0
    t_start = time.perf_counter()
    t_end = t_start
    i = 0
    while True:
        now = time.perf_counter()
        if tracer is not None and not tracer.running and now - t_start >= seconds - trace_s:
            run.untraced_s = now - t_start
            tracer.start()
            t_traced = time.perf_counter()
        traced = tracer is not None and tracer.running
        t0 = time.perf_counter()
        attempted += 1
        try:
            with (tracing.request_span() if traced else contextlib.nullcontext()):
                out, counts = driver.request(i)
            sync()
        except Exception:     # a failed request ends the window, and the run is not correct
            traceback.print_exc(file=sys.stderr)
            failed += 1
            t_end = time.perf_counter()
            break
        t_end = time.perf_counter()
        run.latencies_s.append(t_end - t0)
        _add(run.traced_counts if traced else run.untraced_counts, counts)
        reservoir.offer((i, out))
        del out
        i += 1
        if requests_max and i >= requests_max:
            break
        if t_end - t_start >= seconds and not (traced and t_end - t_traced < trace_s):
            break
    if tracer is not None:
        tracer.stop()
    run.window_s = t_end - t_start
    if run.untraced_s is None:
        run.untraced_s = run.window_s
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    after_window = smi("clocks.sm,temperature.gpu,power.draw") if cuda else "cpu"
    if trace:
        run.trace = tracer.summary()
    found = guard.forbidden_loaded()
    if found:
        raise RuntimeError(f"forbidden modules loaded in the measured process: {found}")

    # -- the check ------------------------------------------------------------
    driver.release()
    builder.close(system)
    del driver, system
    if cuda:
        torch.cuda.empty_cache()
    ctx = Context(cell, seed, device, builder, inputs, requests)
    numbers = entry.check(ctx, reservoir.items)
    limits = cell.workload.get("limits", {})
    checks = {name: {"value": numbers.get(name), "limit": limits[name]} for name in limits}
    correct = (failed == 0 and bool(reservoir.items) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if control:
        result["control"] = entry.check(ctx, reservoir.items, control=control)
        result["program"] = numbers

    # -- metrics ----------------------------------------------------------------
    run.power_limit = smi("name,power.limit") if cuda else "cpu"
    run.device_kind = torch.cuda.get_device_name() if cuda else "cpu"
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = plugins.load_module(root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": run.device_kind,
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(max(setup_peak, window_peak)),
           "memory_peak_bytes_window": int(window_peak),
           "power_limit": run.power_limit,
           "after_window": after_window}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result["metrics"] = metrics
    result["device"] = dev
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["setup_parts_s"] = parts
    result["work"] = {"untraced": run.untraced_counts, "traced": run.traced_counts}
    result["checks"] = checks
    found = guard.forbidden_loaded()
    if found:
        raise RuntimeError(f"forbidden modules loaded in the measured process: {found}")
    return result


def main(argv, root: Path, t_process: float) -> int:
    args = parse_args(argv)
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                          t_process=t_process)
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


__all__ = ["run_cell", "main", "Run", "Reservoir", "NoDevice", "TRACE_S"]
