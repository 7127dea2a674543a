"""Device extent of the serving advance's solves, ms an advance: the
``serve.solve.<algorithm>`` spans of the port's ``repro_torch.obs`` (a pair
of CUDA events on the stream around each group's solve: its kernels and the
idle the host left inside it), summed over the traced window's advances and
divided by their count.  The spans record only under the profiler, so the
last ``advances`` ``serve.advance`` roots are the traced window's.  Nothing
from a port without spans."""


def read(run):
    n = int(run.traced_counts.get("advances", 0))
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = obs.records().spans
    roots = [s for s in spans if s.parent < 0 and s.name == "serve.advance"]
    if not n or len(roots) < n:
        return None
    ids = {s.request for s in roots[-n:]}
    ms = [s.device_ms for s in spans if s.request in ids
          and s.name.startswith("serve.solve.") and s.device_ms is not None]
    return sum(ms) / n if ms else None
