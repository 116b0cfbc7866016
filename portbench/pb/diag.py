"""Diagnostics printed on standard error before and after a window: the
card's name, power limit, SM clock, power draw and temperature, and the
host's CPU count, so that a spread can be traced to the card or the host."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

QUERY = "index,name,power.limit,clocks.sm,power.draw,temperature.gpu,utilization.gpu"


def card_lines() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi: not found"
    try:
        done = subprocess.run([smi, f"--query-gpu={QUERY}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return done.stdout.strip() or done.stderr.strip()


def report(label: str) -> None:
    cpus = os.cpu_count()
    try:
        usable = len(os.sched_getaffinity(0))
    except AttributeError:
        usable = cpus
    load = os.getloadavg() if hasattr(os, "getloadavg") else ("?",)
    print(f"[portbench] {label}: host cpus {cpus} (usable {usable}), load {load}",
          file=sys.stderr)
    for line in card_lines().splitlines():
        print(f"[portbench] {label}: card {line}", file=sys.stderr)
    sys.stderr.flush()
