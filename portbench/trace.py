"""The device trace of a ``--trace 1`` run, reduced to what the metrics
read: the device's busy time (the union of its kernel, copy and fill
intervals), its idle gaps labelled by what the host was doing, and the
device operations that took most time.

``Tracer`` runs ``torch.profiler`` over part of the window; ``collect``
turns its events into plain intervals and ``summarize`` reduces them, so
the arithmetic is testable on synthetic intervals without a card."""
from __future__ import annotations

from collections import defaultdict
from typing import List, NamedTuple, Optional, Sequence, Tuple

SPAN = "portbench.traced"      # the traced part of the window
REQUEST = "portbench.request"  # one request inside it
TOP = 10
NAME_LEN = 96


class Interval(NamedTuple):
    name: str
    start: float    # seconds, on the profiler's clock
    end: float


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: list        # [[name, seconds], ...] most time first
    idle_gaps: list         # [[what the host did, seconds], ...] most time first
    kernel_s: dict          # every device operation's seconds by full name


def merged(intervals: Sequence[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the intervals clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    spans = sorted((max(i.start, lo), min(i.end, hi)) for i in intervals
                   if i.end > lo and i.start < hi)
    out: List[List[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi] that no busy interval covers."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def host_at(times: Sequence[float], host: Sequence[Interval]) -> List[str]:
    """For each time (ascending), the innermost host operation running
    then, with its parent: ``"parent > op"``; host operations nest (one
    thread), so a stack sweep finds them."""
    ops = sorted(host, key=lambda i: (i.start, -i.end))
    labels, stack, k = [], [], 0
    for t in times:
        while k < len(ops) and ops[k].start <= t:
            while stack and stack[-1].end <= ops[k].start:
                stack.pop()
            stack.append(ops[k])
            k += 1
        live = [op for op in stack if op.end > t]
        stack = live
        names = [op.name[:NAME_LEN] for op in live[-2:]]
        labels.append(" > ".join(names) if names else "host outside any operation")
    return labels


def summarize(device: Sequence[Interval], host: Sequence[Interval],
              window: Tuple[float, float]) -> Summary:
    lo, hi = window
    busy = merged(device, lo, hi)
    by_name = defaultdict(float)
    for i in device:
        d = min(i.end, hi) - max(i.start, lo)
        if d > 0:
            by_name[i.name] += d
    holes = gaps(busy, lo, hi)
    idle = defaultdict(float)
    for (a, b), what in zip(holes, host_at([(a + b) / 2 for a, b in holes], host)):
        idle[what] += b - a
    short = defaultdict(float)
    for name, s in by_name.items():
        short[name[:NAME_LEN]] += s

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Summary(hi - lo, sum(b - a for a, b in busy), top(short), top(idle),
                   dict(by_name))


def collect(prof) -> Tuple[List[Interval], List[Interval], Optional[Tuple[float, float]]]:
    """(device intervals, host intervals on the traced span's thread, the
    span) from a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, host, span, span_tid = [], [], None, None
    for ev in events:
        if ev.name() == SPAN and ev.device_type() == DeviceType.CPU:
            span = (ev.start_ns() * 1e-9, ev.end_ns() * 1e-9)
            span_tid = ev.start_thread_id()
    for ev in events:
        iv = Interval(ev.name(), ev.start_ns() * 1e-9, ev.end_ns() * 1e-9)
        if ev.device_type() == DeviceType.CPU:
            if ev.start_thread_id() == span_tid and ev.name() != SPAN:
                host.append(iv)
        elif not ev.is_user_annotation():
            device.append(iv)
    return device, host, span


class Tracer:
    """``torch.profiler`` (CPU and, on a card, CUDA activity) around the
    traced part of the window, marked by a ``SPAN`` range."""

    def __init__(self, device):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if str(device).startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._span = torch.profiler.record_function(SPAN)
        self.running = False

    def start(self):
        self._prof.start()
        self._span.__enter__()
        self.running = True

    def stop(self):
        if self.running:
            self._span.__exit__(None, None, None)
            self._prof.stop()
            self.running = False

    def summary(self) -> Optional[Summary]:
        device, host, span = collect(self._prof)
        if span is None:
            return None
        return summarize(device, host, span)


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up: its first start (CUPTI's
    set-up) takes seconds, which the traced window would otherwise pay."""
    t = Tracer(device)
    t.start()
    t.stop()
    collect(t._prof)


def request_span():
    import torch

    return torch.profiler.record_function(REQUEST)


__all__ = ["Interval", "Summary", "merged", "gaps", "host_at", "summarize", "collect",
           "Tracer", "warm_profiler", "request_span", "SPAN", "REQUEST"]
