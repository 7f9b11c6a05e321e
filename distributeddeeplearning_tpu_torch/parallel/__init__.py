"""Data parallelism of the port: the bucketed gradient all-reduce and the
cross-replica mean of SyncBN (``collectives``), and the process group a
run trains in (``process_group``)."""
