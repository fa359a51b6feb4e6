"""tables_gib (tables): device bytes of the TurboTables tensors, in GiB."""


def read(run):
    return run.tables_bytes / 2**30 if run.tables_bytes else None
