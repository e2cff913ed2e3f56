"""`train_agent_steps_per_s`: every agent-step the window's training calls
took, over the window's wall (ending in a device sync)."""

from port_bench.readers import agent_steps_per_s as read  # noqa: F401
