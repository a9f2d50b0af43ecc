"""``--host-devices N`` for the CLI entry points (port of
``src/repro/launch/host_devices.py``).

The reference writes ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
before jax starts, so that one host shows N placeholder devices.  The port
keeps the flag's parsing only: the CLI passes N ranks as threads of one
process on one device (``models.sharding.LocalGroup(N)``) to the mesh
builders as their ``group``, which is what lets one card run the sharded
code at full width.  :func:`visible_ranks` is the port's
``len(jax.devices())`` for the mesh builders when no group is given.
"""

from __future__ import annotations

from typing import Optional


def force_host_devices(argv) -> Optional[int]:
    """N of ``--host-devices N`` (or ``=N``; the last one wins), or None
    when the flag is absent."""
    n = None
    for i, a in enumerate(argv):
        if a == "--host-devices" and i + 1 < len(argv):
            n = int(argv[i + 1])
        elif a.startswith("--host-devices="):
            n = int(a.split("=", 1)[1])
    if n is not None and n < 1:
        raise ValueError(f"--host-devices {n}: needs at least one rank")
    return n


def visible_ranks() -> int:
    """Ranks a mesh can span without an explicit group: the
    ``torch.distributed`` world size once a process group is up, else 1
    (one device)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
