"""Host clock, synchronized, around the port's graph build in set-up (the
configuration's builder times it: ``from_edges`` and ``build_tger`` on the
host-built graph, ``sort_edges_by_time_per_shard`` on the 1e9-edge one)."""


def read(run):
    return run.graph_build_s
