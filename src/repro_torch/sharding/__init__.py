"""Sharding plans of the port (twin of ``repro/sharding``)."""
