"""Parallelism: the process group and data-parallel training (``mesh``), and
data-parallel serving (``replicas``)."""
