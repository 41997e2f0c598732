"""Host/port utilities (copy of ``areal_tpu/base/network.py``): a
lockfile-coordinated free-port finder whose ports are registered in
name_resolve ``used_ports``.

One difference: :func:`gethostip` answers the loopback address. The
port serves on one host; multi-host serving, and with it a routable
address, waits for ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

import fcntl
import os
import socket
import tempfile
from typing import List, Optional

from areal_tpu_torch.base import name_resolve, names

def gethostname() -> str:
    return socket.gethostname()


def gethostip() -> str:
    return "127.0.0.1"


def _lockfile() -> str:
    return os.path.join(tempfile.gettempdir(), "areal_tpu_torch_ports.lock")


def find_free_ports(
    count: int = 1,
    low: int = 20000,
    high: int = 60000,
    experiment_name: Optional[str] = None,
    trial_name: Optional[str] = None,
) -> List[int]:
    """Find ``count`` distinct free TCP ports.

    A process-shared lockfile serializes the search so concurrent workers on
    one host don't race for the same port; if experiment/trial names are given,
    chosen ports are also registered in name_resolve (and skipped by later
    callers) as the ``used_ports`` registry.
    """
    used = set()
    if experiment_name and trial_name:
        root = names.used_ports(experiment_name, trial_name, gethostname())
        for v in name_resolve.get_subtree(root):
            try:
                used.add(int(v))
            except ValueError:
                pass

    ports: List[int] = []
    with open(_lockfile(), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            for port in range(low, high):
                if port in used:
                    continue
                try:
                    with socket.socket(
                        socket.AF_INET, socket.SOCK_STREAM
                    ) as s:
                        s.setsockopt(
                            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
                        )
                        s.bind(("", port))
                except OSError:
                    continue
                ports.append(port)
                if experiment_name and trial_name:
                    root = names.used_ports(
                        experiment_name, trial_name, gethostname()
                    )
                    name_resolve.add_subentry(root, str(port))
                if len(ports) == count:
                    break
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    if len(ports) < count:
        raise RuntimeError(f"could not find {count} free ports")
    return ports


def find_free_port(**kwargs) -> int:
    return find_free_ports(1, **kwargs)[0]
