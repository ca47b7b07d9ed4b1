"""The one place that decides how a scan runs on the devices it is given.

Every search path that has a hand-written kernel (flat ADC, flat SQ,
IVF-ADC, sharded search, sharded serving) asks `scan_route` which
implementation to trace:

  * ``"pallas"``    — the Pallas kernel compiled for the GPU (Triton route);
  * ``"interpret"`` — the same kernel in the Pallas interpreter: CPU only,
                      and only when the caller asked for the kernel;
  * ``"xla"``       — the plain XLA twin of the kernel.

``impl="auto"`` takes the kernel on a GPU and plain XLA on the CPU; it
never interprets. A platform other than ``gpu`` or ``cpu`` is an error:
nothing falls back silently.
"""

from __future__ import annotations

import jax

IMPLS = ("auto", "pallas", "xla")


def _platform(devices) -> str:
    if devices is None:
        devices = [jax.config.jax_default_device or jax.devices()[0]]
    devices = list(getattr(devices, "flat", devices))
    platforms = {d.platform for d in devices}
    if len(platforms) != 1:
        raise ValueError(f"devices span several platforms: {platforms}")
    return platforms.pop()


def scan_route(devices=None, impl: str = "auto") -> str:
    """Route for a scan over `devices` (a mesh's devices, a device list,
    or None for the default device)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    platform = _platform(devices)
    if platform not in ("gpu", "cpu"):
        raise ValueError(
            f"no scan route for platform {platform!r}: cvt_tpu runs on "
            f"'gpu' (kernel) or 'cpu' (plain XLA, tests)")
    if impl == "xla":
        return "xla"
    if platform == "gpu":
        return "pallas"
    return "interpret" if impl == "pallas" else "xla"
