"""The runtime the port runs on, for the metas of what it writes."""

from __future__ import annotations

import subprocess

import torch


def runtime_fingerprint(device: torch.device | str | None = None) -> dict:
    """``{"torch": version, "cuda": toolkit version or None, "device":
    name}`` for the launcher's JSON meta; on a card also its
    ``"power_limit"`` as ``nvidia-smi`` reads it (a card set below its
    maximum runs slower under load, so a time is read beside it)."""
    device = torch.device(device if device is not None else "cpu")
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type != "cuda":
        out["device"] = "cpu"
        return out
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    out["device"] = torch.cuda.get_device_name(index)
    out["power_limit"] = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out
