"""Serving front ends (port of ``repro.serve``): the streaming engine.

``repro``'s ``SearchSupervisor`` and the LM generation server are not
ported yet (ROADMAP.md Queue 1).
"""
from repro_torch.serve.stream import StreamSearchEngine

__all__ = ["StreamSearchEngine"]
