"""Rounds a query's fixpoint loop ran (``with_rounds``), over all the
window's queries: how deep the queries' temporal paths reach, the work
``fixpoint.ms_per_round`` is paid for."""


def read(run):
    counts = dict(run.untraced_counts)
    for k, v in run.traced_counts.items():
        counts[k] = counts.get(k, 0) + v
    if not counts.get("queries") or "rounds" not in counts:
        return None
    return counts["rounds"] / counts["queries"]
