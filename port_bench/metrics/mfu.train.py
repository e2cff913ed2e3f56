"""`mfu.train`: see `port_bench/readers.py:mfu`."""

from port_bench.readers import mfu as read  # noqa: F401
