"""Mesh construction (port of ``repro/launch/mesh.py``).

Functions, never module-level meshes, so importing this module touches no
process group. A mesh is a ``torch.distributed`` ``DeviceMesh`` over the
default process group, which the caller starts (``torchrun`` or
``init_process_group``); its dimension names are ``repro``'s axis names.

``repro``'s production meshes are ``(16, 16)`` ``("data", "model")`` and
``(2, 16, 16)`` ``("pod", "data", "model")``. The port runs on NVIDIA
H100 cards, whose rates below are what the roofline
(``roofline.analysis``, ``launch.perf_cell``) divides by.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# The port's card: NVIDIA H100 SXM5 80 GB at its full 700 W power limit,
# from NVIDIA's H100 datasheet (dense rates, no sparsity). A card set
# below 700 W runs slower under load: report its name and power limit
# (nvidia-smi --query-gpu=name,power.limit) beside every roofline share.
H100_NAME = "NVIDIA H100 80GB HBM3"
H100_POWER_LIMIT_W = 700.0
H100_PEAK_BF16_FLOPS = 989e12   # FLOP/s, bf16 / fp16 tensor cores
H100_PEAK_FP32_FLOPS = 67e12    # FLOP/s, float32 outside the tensor cores
H100_HBM_BW = 3.35e12           # bytes/s, HBM3
H100_HBM_BYTES = 80e9           # bytes of device memory a card
# NVLink 4: 18 links a card at 25 GB/s a direction each (900 GB/s both
# directions together). An NVSwitch node (HGX H100, 8 cards) lets a ring
# run over all 18, so a card moves 450 GB/s a direction within its node.
H100_NVLINK_LINKS = 18
H100_NVLINK_BW = 450e9          # bytes/s a card, one direction, in a node
H100_NODE_CARDS = 8             # cards a node
# Between nodes a ring runs at the NIC's rate: one 400 Gb/s ConnectX-7 a
# card (NVIDIA DGX H100), 50 GB/s a direction.
H100_NIC_BW = 50e9              # bytes/s a card, one direction

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device_type: str | None) -> str:
    """The mesh's device type: ``device_type``, the caller's device, or
    with None the default group's (NCCL: the card, else the CPU). An NCCL
    group carries only CUDA tensors, so any other type is refused."""
    backend = dist.get_backend()
    if device_type is None:
        return "cuda" if backend == "nccl" else "cpu"
    if backend == "nccl" and device_type != "cuda":
        raise ValueError(
            f"the default group runs NCCL, which carries no {device_type} "
            "tensors: start a gloo group for them")
    return device_type


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default process group: start one with "
            "torchrun or torch.distributed.init_process_group")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """``repro``'s production mesh over the default group: ``(16, 16)``
    ``("data", "model")``, or ``(2, 16, 16)`` ``("pod", "data", "model")``
    with ``multi_pod``, its tensors on ``device_type`` (as
    ``make_local_mesh``). Raises ``ValueError`` unless the world holds
    exactly 256 (512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    need = 1
    for n in shape:
        need *= n
    world = _world()
    kind = _device_type(device_type)
    if world != need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs a world "
            f"size of {need} ranks, got {world}")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, device_type: str | None = None):
    """A ``(world // model_parallel, model_parallel)`` ``("data", "model")``
    mesh over the default group (tests, CPU runs, one card). Its tensors
    live on ``device_type`` (``"cuda"`` or ``"cpu"``: the caller's device;
    gloo ranks may hold either), by default on the card under NCCL and on
    the CPU otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world()
    kind = _device_type(device_type)
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide the world "
            f"size {world}")
    return init_device_mesh(kind, (world // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}``, ``repro``'s ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh) -> torch.device:
    """This rank's device for tensors placed on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
