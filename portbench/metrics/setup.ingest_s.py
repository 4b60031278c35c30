"""The harness clock around the store's bulk load of the generated tuples."""


def read(run):
    return run.setup["ingest_s"]
