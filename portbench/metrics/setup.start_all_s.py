"""The harness clock around the registry's start_all (engine build and
warm-up, the planes started)."""


def read(run):
    return run.setup["start_all_s"]
