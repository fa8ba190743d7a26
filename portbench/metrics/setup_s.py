"""Process start to the start of the window: data generation and parquet
writes, imports, the deployment's start and one pass of the rotation."""


def read(r):
    return r["setup_s"]
