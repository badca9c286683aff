"""Checkpoint readers of the port (copies of ``tpuir/weights``)."""
