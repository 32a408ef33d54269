"""The measurement paths' device checks: they run on NVIDIA GPUs only
and name the card beside every number they print."""

from __future__ import annotations

import subprocess


def gpu_devices(count: int = 1) -> list:
    """JAX's devices, or RuntimeError when they are not ``count`` or more
    GPUs: a measurement never falls back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"no GPU (JAX found {devices[0].platform})")
    if len(devices) < count:
        raise RuntimeError(f"{count} GPUs needed, JAX found {len(devices)}")
    return devices


def card_info() -> str:
    """Name and power limit of every card, as nvidia-smi reports them
    (a child process, off JAX); cards are joined by " | "."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return " | ".join(ln.strip() for ln in out.splitlines() if ln.strip())
