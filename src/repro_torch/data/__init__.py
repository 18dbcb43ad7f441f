"""Deterministic synthetic LM data (twin of ``repro/data``)."""
