"""Atomic, verified checkpoints (twin of ``repro/checkpoint``)."""
