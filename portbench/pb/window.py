"""Bounded run-ahead of a dispatch loop.

A copy of ``unet_implementations_tpu_torch/training/loop.py::_Window``: each
dispatched step is marked on the current stream, and the loop waits for the
mark ``depth`` steps back, so the host stays at most ``depth`` steps ahead of
the device. The waits fall outside the dispatch of a step, so a host
clock around the dispatch alone reads it."""

from __future__ import annotations

from typing import List

import torch


class RunAhead:
    def __init__(self, device: torch.device, depth: int):
        self.cuda = device.type == "cuda"
        self.depth = depth
        self.marks: List = []

    def push(self) -> None:
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
            self.marks.append(event)
            if len(self.marks) > self.depth:
                self.marks.pop(0).synchronize()

    def drain(self) -> None:
        for event in self.marks:
            event.synchronize()
        self.marks.clear()
