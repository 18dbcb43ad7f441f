"""Sequence-parallel communication of the port (twin of ``repro/comm``):
named collectives with a call-time tape, and the allgather state
exchange with its overlap of the intra-chunk kernel."""
