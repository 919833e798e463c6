"""Serving front ends (port of ``repro.serve``): the streaming engine and
its supervisor (checkpoints, retry, rollback-and-replay, resume).

``repro``'s LM generation server is not ported yet (ROADMAP.md Queue 1
item 7).
"""
from repro_torch.serve.stream import StreamSearchEngine
from repro_torch.serve.supervisor import SearchSupervisor

__all__ = ["SearchSupervisor", "StreamSearchEngine"]
