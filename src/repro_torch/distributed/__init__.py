"""Distributed execution (port of ``repro.distributed``): the
fault-tolerance primitives (``TrainingSupervisor`` and ``elastic_reshard``
among them), the partitioning rules (``sharding``: specs as data, DTensor
placements over a ``DeviceMesh``) and the activation-sharding anchors
(``hints``).
"""
