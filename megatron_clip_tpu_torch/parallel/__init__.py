"""Parallelism of the port: the process groups of the data, fsdp and
tensor axes (`mesh.py`), their collectives (`collectives.py`) and the
parameters' shards (`sharding.py`)."""
