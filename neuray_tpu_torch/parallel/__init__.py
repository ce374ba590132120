"""Multi-GPU execution over ``torch.distributed`` (``sharding.py``) and
the spawner that runs a function on fresh rank processes (``spawn.py``)."""
