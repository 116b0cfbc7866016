"""Data parallelism across processes: the process group
(``distributed``) and the data-parallel context (``mesh``)."""
