"""Rows a serving advance solved after cross-tenant dedup
(``SweepState.n_solved_unique``), summed over the window's advances and
divided by their count."""


def read(run):
    counts = dict(run.untraced_counts)
    for k, v in run.traced_counts.items():
        counts[k] = counts.get(k, 0) + v
    if not counts.get("advances"):
        return None
    return counts["rows_solved_unique"] / counts["advances"]
