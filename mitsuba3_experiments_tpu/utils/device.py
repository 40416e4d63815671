"""The device a measurement runs on: refuse anything but a GPU, name the
card and its power limit, read peak device memory."""
from __future__ import annotations

import subprocess
import sys


def require_gpu():
    """The first JAX device; exits with status 2 unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; JAX found {dev.platform} ({dev.device_kind})",
              file=sys.stderr)
        sys.exit(2)
    return dev


def card_info() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def peak_bytes(dev=None) -> int:
    """peak_bytes_in_use of `dev` (default: the first device)."""
    import jax

    dev = dev or jax.devices()[0]
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))
