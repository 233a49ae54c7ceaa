"""Checkpoint and resume of the render state.

Port of ``gpu_bidirectional_raytracer_tpu/utils/checkpoint.py``, which
saves the whole `RenderState` through orbax. Here a step is one
``torch.save`` of a plain dict (so ``torch.load`` with its default
``weights_only=True`` reads it back): the colors, the counter, the VPL
buffer, ``vlp_index``, ``sample``, the key's words and its tape's name,
and a format version. With the counter-addressed tape, a resumed render
continues bit for bit. The latest two steps are kept, as JAX's
``max_to_keep=2`` does.
"""

from __future__ import annotations

import os
import re

import torch

from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    RenderState,
    VplBuffer,
)

FORMAT = 1
MAX_TO_KEEP = 2
_STEP = re.compile(r"^step_(\d+)\.pt$")
_VPL_FIELDS = ("hp", "rad", "nl", "valid", "sid")


class TapeMismatch(ValueError):
    """A checkpoint written under another tape than the template's."""

    def __init__(self, directory: str, stored: str, requested: str):
        super().__init__(f"checkpoint at {directory} was written under the "
                         f"{stored} tape, not {requested}")
        self.stored = stored
        self.requested = requested


def _steps(directory: str) -> list[tuple[int, str]]:
    """``(step, path)`` of every checkpoint in ``directory``, oldest
    first."""
    found = []
    for name in os.listdir(directory):
        m = _STEP.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(found)


def save(directory: str, state: RenderState) -> None:
    """Save ``state`` as step ``state.sample``, then drop all but the
    latest two steps. The file is written beside its name and renamed
    into place, so a reader never sees half of one."""
    os.makedirs(directory, exist_ok=True)
    blob = {
        "format": FORMAT,
        "colors": state.colors.detach().cpu(),
        "counter": state.counter.detach().cpu(),
        "vpls": {f: getattr(state.vpls, f).detach().cpu()
                 for f in _VPL_FIELDS},
        "vlp_index": int(state.vlp_index),
        "sample": int(state.sample),
        "key": [int(w) for w in state.key],
        "key_impl": rng.key_impl(state.key),
    }
    path = os.path.join(directory, f"step_{int(state.sample):010d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    for _, old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(old)


def restore(directory: str, template: RenderState | None
            ) -> RenderState | None:
    """The latest checkpoint in ``directory`` on ``template``'s device, or
    None when there is none. Raises :class:`TapeMismatch` when it was
    written under another tape than ``template``'s key draws."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    if not steps:
        return None
    blob = torch.load(steps[-1][1], map_location="cpu", weights_only=True)
    if blob.get("format") != FORMAT:
        raise ValueError(f"{steps[-1][1]}: checkpoint format "
                         f"{blob.get('format')!r}, expected {FORMAT}")
    stored = blob["key_impl"]
    requested = rng.key_impl(template.key)
    if stored != requested:
        raise TapeMismatch(directory, stored, requested)
    dev = template.colors.device
    return RenderState(
        colors=blob["colors"].to(dev),
        counter=blob["counter"].to(dev),
        vpls=VplBuffer(**{f: blob["vpls"][f].to(dev) for f in _VPL_FIELDS}),
        vlp_index=int(blob["vlp_index"]),
        sample=int(blob["sample"]),
        key=rng.make_typed_key(blob["key"], stored),
    )
