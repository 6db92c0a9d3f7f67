"""Frozen copy of the program's `tensors.py`, for the benchmark's plain
reference; its own description follows.

Dataclasses of tensors with an explicit `.to(device)`.

The scene, BVH, camera and tables are plain dataclasses whose tensor
fields (and nested TensorData fields) move together; every other field
(ints, tuples of static facts) is carried over unchanged.
"""

from __future__ import annotations

import dataclasses

import torch


class TensorData:
    """Mixin for dataclasses whose fields are tensors / nested TensorData."""

    def to(self, device):
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if torch.is_tensor(v) or isinstance(v, TensorData):
                changes[f.name] = v.to(device)
        return dataclasses.replace(self, **changes)
