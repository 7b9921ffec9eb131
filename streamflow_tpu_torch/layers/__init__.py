"""Layers of the port (counterparts of streamflow_tpu.layers)."""
