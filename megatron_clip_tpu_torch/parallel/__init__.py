"""Parallelism of the port: the data-parallel process group
(`mesh.py`)."""
