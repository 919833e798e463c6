"""Distributed execution (port of ``repro.distributed``): the
fault-tolerance primitives, ``TrainingSupervisor`` among them, and the
activation-sharding anchors (``hints``, identities on one device).
Sharding and ``elastic_reshard`` are not ported yet (ROADMAP.md Queue 1
item 7c).
"""
