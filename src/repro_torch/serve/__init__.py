"""Serving front ends (port of ``repro.serve``): batched LM generation
(``generate``), the streaming engine and its supervisor (checkpoints,
retry, rollback-and-replay, resume).
"""
from repro_torch.serve.generate import generate
from repro_torch.serve.stream import StreamSearchEngine
from repro_torch.serve.supervisor import SearchSupervisor

__all__ = ["SearchSupervisor", "StreamSearchEngine", "generate"]
