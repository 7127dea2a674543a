"""The untraced part of the window's time over all rounds of all its
queries (the rounds each query's fixpoint loop ran, ``with_rounds``), ms."""


def read(run):
    rounds = run.untraced_counts.get("rounds", 0)
    if rounds <= 0:
        return None
    return 1e3 * run.untraced_s / rounds
