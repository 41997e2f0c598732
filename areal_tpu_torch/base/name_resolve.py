"""Key-value discovery & synchronization service (copy of
``areal_tpu/base/name_resolve.py``: the memory, nfs and server backends).

Every worker discovery, barrier, version announcement, and address exchange
goes through this module.  The default backend is in-memory (single
process); the file backend supports multi-process / multi-host via a shared
filesystem, rooted under ``AREAL_NAME_RESOLVE_ROOT`` or the process's
temporary directory; the ``server`` backend talks to the ZMQ KV service of
``base/name_resolve_server.py`` at ``AREAL_NAME_RESOLVE_ADDR``.
"""

from __future__ import annotations

import os
import random
import shutil
import tempfile
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("name_resolve")


class NameEntryExistsError(Exception):
    pass


class NameEntryNotFoundError(Exception):
    pass


class NameRecordRepository:
    """Abstract KV repository with watch/keepalive semantics."""

    def add(
        self,
        name: str,
        value: str,
        delete_on_exit: bool = True,
        keepalive_ttl: Optional[float] = None,
        replace: bool = False,
    ):
        raise NotImplementedError()

    def add_subentry(self, name: str, value: str, **kwargs) -> str:
        """Add ``name/<uuid>`` = value; returns the sub-name."""
        sub_name = f"{name.rstrip('/')}/{uuid.uuid4().hex[:8]}"
        self.add(sub_name, value, **kwargs)
        return sub_name

    def delete(self, name: str):
        raise NotImplementedError()

    def clear_subtree(self, name_root: str):
        raise NotImplementedError()

    def get(self, name: str) -> str:
        raise NotImplementedError()

    def get_subtree(self, name_root: str) -> List[str]:
        """Values of all keys under the subtree, sorted by key."""
        raise NotImplementedError()

    def find_subtree(self, name_root: str) -> List[str]:
        """Keys (not values) under the subtree, sorted."""
        raise NotImplementedError()

    def wait(
        self,
        name: str,
        timeout: Optional[float] = None,
        poll_frequency: float = 0.1,
    ) -> str:
        """Block until ``name`` exists, returning its value."""
        start = time.monotonic()
        while True:
            try:
                return self.get(name)
            except NameEntryNotFoundError:
                if timeout is not None and time.monotonic() - start > timeout:
                    raise TimeoutError(
                        f"name_resolve.wait timeout after {timeout}s: {name}"
                    )
                time.sleep(poll_frequency + random.random() * 0.02)

    def watch_names(
        self,
        names: List[str],
        call_back: Callable[[], None],
        poll_frequency: float = 5.0,
        wait_timeout: float = 60.0,
    ):
        """Spawn a daemon thread that calls ``call_back`` once ANY of the names
        disappears (after first appearing).  Used for worker failure detection
        (reference: realhf/system/worker_base.py:701-708)."""
        if isinstance(names, str):
            names = [names]

        def _watch():
            try:
                for n in names:
                    self.wait(n, timeout=wait_timeout)
                while True:
                    for n in names:
                        try:
                            self.get(n)
                        except NameEntryNotFoundError:
                            logger.info("watched name %s disappeared", n)
                            call_back()
                            return
                    time.sleep(poll_frequency)
            except Exception:
                logger.exception("watch thread failed")
                call_back()

        t = threading.Thread(target=_watch, daemon=True)
        t.start()
        return t

    def reset(self):
        """Cleanup all entries added by this repository instance."""
        raise NotImplementedError()


class MemoryNameRecordRepository(NameRecordRepository):
    """Process-local dict-backed store (reference :186)."""

    def __init__(self):
        self.__store: Dict[str, str] = {}
        self.__lock = threading.Lock()

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        name = str(name).rstrip("/")
        if not name:
            raise ValueError("name cannot be empty")
        with self.__lock:
            if name in self.__store and not replace:
                raise NameEntryExistsError(name)
            self.__store[name] = str(value)

    def delete(self, name):
        with self.__lock:
            if name not in self.__store:
                raise NameEntryNotFoundError(name)
            del self.__store[name]

    def clear_subtree(self, name_root):
        with self.__lock:
            prefix = name_root.rstrip("/")
            keys = [
                k for k in self.__store if k == prefix or k.startswith(prefix + "/")
            ]
            for k in keys:
                del self.__store[k]

    def get(self, name):
        name = str(name).rstrip("/")
        with self.__lock:
            if name not in self.__store:
                raise NameEntryNotFoundError(name)
            return self.__store[name]

    def get_subtree(self, name_root):
        with self.__lock:
            prefix = name_root.rstrip("/")
            return [
                v
                for k, v in sorted(self.__store.items())
                if k == prefix or k.startswith(prefix + "/")
            ]

    def find_subtree(self, name_root):
        with self.__lock:
            prefix = name_root.rstrip("/")
            return sorted(
                k
                for k in self.__store
                if k == prefix or k.startswith(prefix + "/")
            )

    def reset(self):
        with self.__lock:
            self.__store.clear()


class NfsNameRecordRepository(NameRecordRepository):
    """Shared-filesystem store: one file per key (reference :286).

    Works across processes and across hosts that share the record root
    (NFS/GCS-fuse).  Values live in ``<root>/<key>/ENTRY``.
    """

    ENTRY = "ENTRY"

    def __init__(self, record_root: Optional[str] = None):
        self.record_root = record_root or os.environ.get(
            "AREAL_NAME_RESOLVE_ROOT",
            os.path.join(tempfile.gettempdir(), "areal_tpu_torch", "name_resolve"),
        )
        self.__to_delete = set()

    def __dir_path(self, name: str) -> str:
        return os.path.join(self.record_root, name.strip("/"))

    def __file_path(self, name: str) -> str:
        return os.path.join(self.__dir_path(name), self.ENTRY)

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        path = self.__file_path(name)
        if os.path.isfile(path) and not replace:
            raise NameEntryExistsError(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            f.write(str(value))
        os.replace(tmp, path)
        if delete_on_exit:
            self.__to_delete.add(name)

    def delete(self, name):
        path = self.__file_path(name)
        if not os.path.isfile(path):
            raise NameEntryNotFoundError(name)
        os.remove(path)
        self.__to_delete.discard(name)
        # prune now-empty dirs
        d = os.path.dirname(path)
        while d != self.record_root:
            try:
                os.rmdir(d)
            except OSError:
                break
            d = os.path.dirname(d)

    def clear_subtree(self, name_root):
        path = self.__dir_path(name_root)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)

    def get(self, name):
        path = self.__file_path(name)
        try:
            with open(path, "r") as f:
                return f.read()
        except FileNotFoundError:
            raise NameEntryNotFoundError(name) from None

    def _walk(self, name_root):
        root = self.__dir_path(name_root)
        out = []
        if not os.path.isdir(root):
            return out
        for dirpath, _, filenames in os.walk(root):
            if self.ENTRY in filenames:
                rel = os.path.relpath(dirpath, self.record_root)
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    def get_subtree(self, name_root):
        return [self.get(k) for k in self._walk(name_root)]

    def find_subtree(self, name_root):
        return self._walk(name_root)

    def reset(self):
        for name in list(self.__to_delete):
            try:
                self.delete(name)
            except NameEntryNotFoundError:
                pass
        self.__to_delete.clear()


DEFAULT_REPOSITORY: NameRecordRepository = MemoryNameRecordRepository()


def reconfigure(backend: str = "memory", **kwargs) -> NameRecordRepository:
    """Swap the process-global repository (reference :1386)."""
    global DEFAULT_REPOSITORY
    try:
        DEFAULT_REPOSITORY.reset()
    except Exception:
        pass
    if backend == "memory":
        DEFAULT_REPOSITORY = MemoryNameRecordRepository()
    elif backend in ("nfs", "file"):
        DEFAULT_REPOSITORY = NfsNameRecordRepository(**kwargs)
    elif backend == "server":
        # the ZMQ KV service of base/name_resolve_server.py
        from areal_tpu_torch.base.name_resolve_server import (
            ServerNameRecordRepository,
        )

        address = kwargs.pop(
            "address", os.environ.get("AREAL_NAME_RESOLVE_ADDR", "")
        )
        if not address:
            raise ValueError(
                "server backend needs address=host:port or "
                "AREAL_NAME_RESOLVE_ADDR"
            )
        DEFAULT_REPOSITORY = ServerNameRecordRepository(address)
    else:
        raise NotImplementedError(f"name_resolve backend {backend}")
    return DEFAULT_REPOSITORY


def add(name, value, **kwargs):
    return DEFAULT_REPOSITORY.add(name, value, **kwargs)


def add_subentry(name, value, **kwargs):
    return DEFAULT_REPOSITORY.add_subentry(name, value, **kwargs)


def delete(name):
    return DEFAULT_REPOSITORY.delete(name)


def clear_subtree(name_root):
    return DEFAULT_REPOSITORY.clear_subtree(name_root)


def get(name):
    return DEFAULT_REPOSITORY.get(name)


def get_subtree(name_root):
    return DEFAULT_REPOSITORY.get_subtree(name_root)


def find_subtree(name_root):
    return DEFAULT_REPOSITORY.find_subtree(name_root)


def wait(name, **kwargs):
    return DEFAULT_REPOSITORY.wait(name, **kwargs)


def watch_names(names, call_back, **kwargs):
    return DEFAULT_REPOSITORY.watch_names(names, call_back, **kwargs)


def reset():
    return DEFAULT_REPOSITORY.reset()
