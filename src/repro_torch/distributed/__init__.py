"""Distributed execution (port of ``repro.distributed``): the search-side
fault-tolerance primitives and the activation-sharding anchors
(``hints``, identities on one device). Sharding and the LM trainer's
supervision are not ported yet (ROADMAP.md Queue 1 items 7b and 7c).
"""
