"""Sequence-level data parallelism: N independent VO sequences, one per mesh
slot (port of ``parallel/seq_dp.py``).

A slot is a torch device: slot ``s`` of a mesh over ``devices`` runs on
``devices[s % len(devices)]``, so one card can hold every slot.  As the
reference's ``jax.jit(jax.vmap(vo._step_impl))`` steps every slot in one
program, ``batched_step`` steps the slots of each device as one batch
(``VisualOdometry.step_batch``): ``torch.func.vmap`` of the step's body,
both LK kernels taking the whole batch in one launch, captured once per
batch size and replayed once a frame for all the device's slots.  Slots
share nothing, so there is no collective.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.state import FrameState, stack_states
from ..pipeline.vo import VisualOdometry


@dataclasses.dataclass(frozen=True)
class SlotMesh:
    devices: Tuple[torch.device, ...]  # one per slot
    axis: str = "data"


def make_mesh(n_devices: int, axis: str = "data",
              devices: Optional[Sequence] = None) -> SlotMesh:
    """``n_devices`` slots over ``devices`` (every visible CUDA device when
    None; pass ``["cpu"]`` to run the slots on the CPU)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=['cpu'] to run the slots on the CPU")
    devices = [_resolved(torch.device(d)) for d in devices]
    return SlotMesh(tuple(devices[s % len(devices)]
                          for s in range(n_devices)), axis)


def _resolved(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def slot_vos(vo: VisualOdometry, mesh: SlotMesh) -> List[VisualOdometry]:
    """The ``VisualOdometry`` of each slot: ``vo`` itself on its own device,
    a copy with its camera, config and sampler on any other."""
    by_device = {_resolved(vo.device): vo}
    for dev in mesh.devices:
        if dev not in by_device:
            by_device[dev] = VisualOdometry(
                vo.cam, vo.config, dev, sampler=vo.sampler, seed=vo.seed)
    return [by_device[dev] for dev in mesh.devices]


def device_groups(mesh: SlotMesh) -> List[Tuple[torch.device, List[int]]]:
    """The slots of each device of ``mesh``, the devices in the order they
    first appear: each group is one batch of the batched step."""
    groups: Dict[torch.device, List[int]] = {}
    for s, dev in enumerate(mesh.devices):
        groups.setdefault(dev, []).append(s)
    return list(groups.items())


def stack_slots(states: Sequence[FrameState],
                mesh: SlotMesh) -> List[FrameState]:
    """Per-slot states, in slot order, as one stacked state per device
    group (``device_groups``): the batches ``batched_step`` takes."""
    return [stack_states([states[s] for s in slots])
            for _, slots in device_groups(mesh)]


def batched_step(vo: VisualOdometry, mesh: SlotMesh) -> Callable:
    """``step(batches, images, generators, outputs=None) -> batches``: one
    ``step_batch`` per device group, on that device's VO (``slot_vos``), so
    a card replays one captured step a frame for all its slots.

    ``batches``: one stacked state per group (``stack_slots``); ``images``
    and ``generators``: one per slot, in slot order (slot s draws from
    ``generators[s]`` exactly as a solo ``step`` would); ``outputs``: None,
    or one uint8 buffer per group that gets its slots' ``frame_outputs``
    (``VisualOdometry.step_batch``)."""
    vos = slot_vos(vo, mesh)
    groups = device_groups(mesh)

    def step(batches, images, generators, outputs=None):
        return [vos[slots[0]].step_batch(
                    states, [images[s] for s in slots],
                    [generators[s] for s in slots],
                    outputs=None if outputs is None else outputs[g])
                for g, ((_, slots), states) in enumerate(zip(groups,
                                                             batches))]

    return step


def dryrun(vo: VisualOdometry, n_devices: int, axis: str = "data") -> None:
    """Bootstrap every slot on blank frames and step them once as batches
    (on every visible card when ``vo`` runs on one, on ``vo``'s device
    otherwise)."""
    mesh = make_mesh(n_devices, axis, None if vo.device.type == "cuda"
                     else [vo.device])
    H, W = vo.config.image_shape
    img = torch.zeros((H, W), dtype=torch.float32)
    states = [v.bootstrap(img, img) for v in slot_vos(vo, mesh)]
    gens = [torch.Generator(device=dev).manual_seed(s)
            for s, dev in enumerate(mesh.devices)]
    out = batched_step(vo, mesh)(stack_slots(states, mesh),
                                 [img] * n_devices, gens)
    assert torch.cat([b.T_CW.cpu() for b in out]).shape == (n_devices, 4, 4)
