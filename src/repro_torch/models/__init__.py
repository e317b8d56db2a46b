"""The model stack (port of ``repro/models``): the hybrid family (zamba2)
so far — Mamba2 mixer, attention, and the assembled decoder."""
