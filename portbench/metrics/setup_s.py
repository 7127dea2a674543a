"""Process start to the first timed request: generation, graph build,
index, traffic draw, kernel load and warm-up."""


def read(run):
    return run.setup_s
