"""Explicit device selection.

The port never picks a device by itself: callers name "cuda" or "cpu".
Asking for CUDA where there is no card raises instead of falling back to
the CPU, so a measurement can never silently run on the wrong device.
"""

from __future__ import annotations

import subprocess

import torch


def get_device(name) -> torch.device:
    """"cuda", "cuda:N" or "cpu" (or a torch.device) -> torch.device."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the
    CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _card_index(device) -> int:
    dev = torch.device(device)
    return dev.index if dev.index is not None else torch.cuda.current_device()


def smi_query(device, fields: str) -> str | None:
    """`nvidia-smi --query-gpu=<fields> --format=csv,noheader` for the
    card `device`, e.g. "clocks.sm,power.draw,temperature.gpu"; None
    where nvidia-smi is missing or fails."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "-i", str(_card_index(device)),
             f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return res.stdout.strip().splitlines()[0]


def card_line(device) -> str:
    """The device a measurement ran on: for a card, its name and power
    limit as `nvidia-smi --query-gpu=name,power.limit --format=csv,
    noheader` gives them (the name alone, and that the limit was not
    read, where nvidia-smi is missing); "cpu" for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return smi_query(device, "name,power.limit") or (
        f"{torch.cuda.get_device_name(_card_index(device))}, power limit "
        f"not read")
