"""Seconds from the process start until the window opens: imports, the
kernels from the build cache, the graph generated, the store ingest,
start_all, the clients started and warmed up."""


def read(run):
    return run.setup["setup_s"]
