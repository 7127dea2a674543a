"""The combine layer's share of its memory roofline in the traced window,
%: the bytes the traced queries' combines need, at the card's memory
bandwidth, over the device time of the kernels the combine layer launches.

The bytes follow the work the queries ask for, from counts the run has
apart from the program (the edges inside each window, from the
benchmark's own draw): a temporal PageRank query reads each inside edge's
source id once for the window's out-degree and writes the [V] degrees
once (4 bytes each), then each of its iterations reads each inside edge's
contribution (8 bytes: the sums are float64) and destination id (4 bytes)
once and writes the [V] float64 sums once.  The time is that of the device
operations whose names match ``KERNELS``: K1, K3 and the library scatter
kernels of ``segment_combine`` (``scatter_reduce_`` and ``index_add_``)."""
import re

from portbench.peaks import peak

ID_BYTES = 4
DEGREE_BYTES = 4
SUM_BYTES = 8
KERNELS = re.compile(
    r"segment_min_tiles_kernel|segment_spmm_tiles_kernel"
    r"|_scatter_gather_elementwise_kernel.*Reduce(Minimum|Maximum|Add|Multiply|Mean)"
    r"|indexFunc(Small|Large)Index|index_add")


def pagerank_bytes(counts) -> int:
    """Bytes of the traced PageRank queries' combines (0 without any)."""
    q = counts.get("queries", 0)
    if not q or "window_edge_iterations" not in counts:
        return 0
    v = counts["vertices"] // q
    degree = counts["window_edges"] * ID_BYTES + q * v * DEGREE_BYTES
    rounds = (counts["window_edge_iterations"] * (SUM_BYTES + ID_BYTES)
              + counts["iterations"] * v * SUM_BYTES)
    return degree + rounds


def combine_seconds(kernel_s: dict) -> float:
    return sum(s for name, s in kernel_s.items() if KERNELS.search(name))


def read(run):
    if run.trace is None:
        return None
    nbytes = pagerank_bytes(run.traced_counts)
    bw = peak(run.device_kind, "hbm_bytes_per_s")
    seconds = combine_seconds(run.trace.kernel_s)
    if not nbytes or bw is None or seconds <= 0:
        return None
    return 100.0 * nbytes / bw / seconds
