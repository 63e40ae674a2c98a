"""The card a run measures on: what ``torch`` and a read-only ``nvidia-smi``
query say about it. Nothing here changes a setting."""

from __future__ import annotations

import subprocess

import torch

CLOCK_FIELDS = ("name", "power.limit", "clocks.sm", "clocks.max.sm", "power.draw",
                "temperature.gpu", "clocks_throttle_reasons.active")


def smi(index: int, fields=CLOCK_FIELDS) -> dict:
    """``nvidia-smi --query-gpu`` of one card, or {'error': ...} where the
    query fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return {"error": str(e)}
    values = [v.strip() for v in out.stdout.strip().split(",")]
    return dict(zip(fields, values))


def require(chips: int) -> None:
    """Raise SystemExit unless ``chips`` CUDA cards are present: the
    measurement never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, torch sees "
                         f"{torch.cuda.device_count()}")


def device_line(device, count: int, peak_bytes: int) -> dict:
    """The result line's ``device``; a run the tests drive on the CPU says
    so."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def warm_libraries(device) -> None:
    """Loads the card's convolution and matrix libraries with one small call
    of each in float32 and bfloat16, so that their one-time start is paid
    on the set-up's clock, whatever runs first."""
    if device.type != "cuda":
        return
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones(1, 8, 8, 8, device=device, dtype=dtype)
        torch.nn.functional.conv2d(x, torch.ones(8, 8, 3, 3, device=device, dtype=dtype))
        x.reshape(8, 64) @ torch.ones(64, 8, device=device, dtype=dtype)
    torch.cuda.synchronize(device)
