"""`starved_share.train`: see `port_bench/readers.py:starved_share`."""

from port_bench.readers import starved_share as read  # noqa: F401
