"""`device_idle.train`: see `port_bench/readers.py:device_idle`."""

from port_bench.readers import device_idle as read  # noqa: F401
