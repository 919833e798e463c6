"""Roofline tooling (port of ``repro/roofline``): per-device counters at
dispatch (``op_stats``) and the three-term roofline on the H100's rates
(``analysis``)."""
