"""Distributed execution (port of ``repro.distributed``): the search-side
fault-tolerance primitives. Sharding and the LM trainer's supervision are
not ported yet (ROADMAP.md Queue 1 items 5 and 7).
"""
