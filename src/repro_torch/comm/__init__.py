"""Sequence-parallel communication of the port (twin of ``repro/comm``):
named collectives with a call-time tape, the state exchanges of LASP-2
layers and their registry, and the spec that selects one."""
