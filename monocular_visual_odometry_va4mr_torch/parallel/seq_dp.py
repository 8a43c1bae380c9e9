"""Sequence-level data parallelism: N independent VO sequences, one per mesh
slot (port of ``parallel/seq_dp.py``).

A slot is a torch device: slot ``s`` of a mesh over ``devices`` runs on
``devices[s % len(devices)]``, so one card can hold every slot.  The step
launches a hand-written CUDA kernel through ctypes and cannot be vmapped, so
lockstep is a loop over the slots, each stepped by a ``VisualOdometry`` on
its slot's device; slots share nothing, so there is no collective.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

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
            by_device[dev] = VisualOdometry(vo.cam, vo.config, dev,
                                            sampler=vo.sampler, seed=vo.seed)
    return [by_device[dev] for dev in mesh.devices]


def batched_step(vo: VisualOdometry, mesh: SlotMesh) -> Callable:
    """``step(states, images, generators) -> states``: one ``step`` per
    slot, in slot order, each on its slot's device."""
    vos = slot_vos(vo, mesh)

    def step(states, images, generators):
        return [v.step(st, img, generator=g)
                for v, st, img, g in zip(vos, states, images, generators)]

    return step


def dryrun(vo: VisualOdometry, n_devices: int, axis: str = "data") -> None:
    """Bootstrap and step every slot once on blank frames (on every visible
    card when ``vo`` runs on one, on ``vo``'s device otherwise)."""
    mesh = make_mesh(n_devices, axis, None if vo.device.type == "cuda"
                     else [vo.device])
    H, W = vo.config.image_shape
    img = torch.zeros((H, W), dtype=torch.float32)
    states = [v.bootstrap(img, img) for v in slot_vos(vo, mesh)]
    gens = [torch.Generator(device=dev).manual_seed(s)
            for s, dev in enumerate(mesh.devices)]
    out = batched_step(vo, mesh)(states, [img] * n_devices, gens)
    assert torch.stack([s.T_CW.cpu() for s in out]).shape == (n_devices, 4, 4)
