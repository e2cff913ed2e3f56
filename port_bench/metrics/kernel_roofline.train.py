"""`kernel_roofline.train`: see `port_bench/readers.py:kernel_roofline`."""

from port_bench.readers import kernel_roofline as read  # noqa: F401
