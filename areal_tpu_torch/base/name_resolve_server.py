"""Self-hosted name-resolve service: a ZMQ key-value server with TTLs
(port of ``areal_tpu/base/name_resolve_server.py``).

One small server process (typically on the launcher's host) answers JSON
requests over ZMQ REQ/REP; the server expires keys whose TTL lapsed and
each client refreshes its keepalive keys from a daemon thread (etcd's
lease and keepalive semantics without an external store).  The wire
format is the JAX package's, byte for byte: either package's client
talks to either package's server.

Server:  ``python -m areal_tpu_torch.base.name_resolve_server --port 7777``
Clients: ``name_resolve.reconfigure("server", address="host:7777")`` or
``AREAL_NAME_RESOLVE=server AREAL_NAME_RESOLVE_ADDR=host:7777``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

import zmq

from areal_tpu_torch.base import logging_
from areal_tpu_torch.base.name_resolve import (
    NameEntryExistsError,
    NameEntryNotFoundError,
    NameRecordRepository,
)

logger = logging_.getLogger("name_resolve_server")


def _under(key: str, root: str) -> bool:
    return key == root or key.startswith(root + "/")


class NameResolveServer:
    """Threaded KV server; its store maps key -> (value, expiry or None)."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REP)
        if port == 0:
            self.port = self._sock.bind_to_random_port(f"tcp://{host}")
        else:
            self._sock.bind(f"tcp://{host}:{port}")
            self.port = port
        self._store: Dict[str, Tuple[str, Optional[float]]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(
            target=self._serve, name="name-resolve-server", daemon=True
        )
        self._thread.start()
        return self

    def _sweep(self):
        now = time.monotonic()
        for k in [k for k, (_, exp) in self._store.items()
                  if exp is not None and exp < now]:
            del self._store[k]

    def _handle(self, req: Dict) -> Dict:
        op = req["op"]
        key = req.get("key", "")
        with self._lock:
            self._sweep()
            if op == "add":
                if key in self._store and not req.get("replace", False):
                    return {"ok": False, "err": "exists"}
                ttl = req.get("ttl")
                self._store[key] = (
                    req["value"], time.monotonic() + ttl if ttl else None
                )
                return {"ok": True}
            if op == "touch":
                if key not in self._store:
                    return {"ok": False, "err": "notfound"}
                ttl = req.get("ttl")
                self._store[key] = (
                    self._store[key][0],
                    time.monotonic() + ttl if ttl else None,
                )
                return {"ok": True}
            if op == "get":
                if key not in self._store:
                    return {"ok": False, "err": "notfound"}
                return {"ok": True, "value": self._store[key][0]}
            if op == "delete":
                if key not in self._store:
                    return {"ok": False, "err": "notfound"}
                del self._store[key]
                return {"ok": True}
            if op == "clear_subtree":
                root = key.rstrip("/")
                dead = [k for k in self._store if _under(k, root)]
                for k in dead:
                    del self._store[k]
                return {"ok": True, "n": len(dead)}
            if op == "get_subtree":
                root = key.rstrip("/")
                items = sorted((k, v[0]) for k, v in self._store.items()
                               if _under(k, root))
                return {"ok": True, "keys": [k for k, _ in items],
                        "values": [v for _, v in items]}
            if op == "ping":
                return {"ok": True, "n_keys": len(self._store)}
        return {"ok": False, "err": f"bad op {op}"}

    def _serve(self):
        poller = zmq.Poller()
        poller.register(self._sock, zmq.POLLIN)
        while not self._stop.is_set():
            if not dict(poller.poll(timeout=100)):
                continue
            raw = self._sock.recv()
            try:
                resp = self._handle(json.loads(raw.decode()))
            except Exception as e:  # noqa: BLE001 - the server must not die
                logger.exception("bad request")
                resp = {"ok": False, "err": repr(e)}
            self._sock.send(json.dumps(resp).encode())

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self._sock.close(linger=0)


class ServerNameRecordRepository(NameRecordRepository):
    """Client of a :class:`NameResolveServer`.

    Keys added with ``keepalive_ttl`` are refreshed by a daemon thread at a
    third of their TTL; keys added with ``delete_on_exit`` are deleted by
    :meth:`reset`.
    """

    REQUEST_TIMEOUT = 5.0

    def __init__(self, address: str):
        self._address = address
        self._ctx = zmq.Context.instance()
        self._lock = threading.Lock()
        self._sock = self._new_socket()
        self._to_delete: set = set()
        self._keepalive: Dict[str, float] = {}
        self._stop = threading.Event()
        self._ka_thread: Optional[threading.Thread] = None

    def _new_socket(self):
        sock = self._ctx.socket(zmq.REQ)
        sock.setsockopt(zmq.LINGER, 0)
        sock.connect(f"tcp://{self._address}")
        return sock

    def _call(self, req: Dict) -> Dict:
        with self._lock:
            self._sock.send(json.dumps(req).encode())
            if not self._sock.poll(int(self.REQUEST_TIMEOUT * 1000)):
                # a REQ socket that lost its reply cannot send again
                self._sock.close(linger=0)
                self._sock = self._new_socket()
                raise TimeoutError(
                    f"name_resolve server {self._address} timed out"
                )
            return json.loads(self._sock.recv().decode())

    def add(
        self,
        name: str,
        value: str,
        delete_on_exit: bool = True,
        keepalive_ttl: Optional[float] = None,
        replace: bool = False,
    ):
        resp = self._call({"op": "add", "key": name, "value": str(value),
                           "replace": replace, "ttl": keepalive_ttl})
        if not resp["ok"]:
            raise NameEntryExistsError(name)
        if delete_on_exit:
            self._to_delete.add(name)
        if keepalive_ttl:
            self._keepalive[name] = keepalive_ttl
            self._ensure_keepalive()

    def _ensure_keepalive(self):
        if self._ka_thread is not None:
            return

        def _loop():
            next_at: Dict[str, float] = {}
            while not self._stop.wait(0.2):
                now = time.monotonic()
                for key, ttl in list(self._keepalive.items()):
                    if now < next_at.get(key, 0.0):
                        continue
                    try:
                        self._call({"op": "touch", "key": key, "ttl": ttl})
                    except (TimeoutError, zmq.ZMQError):
                        pass
                    next_at[key] = now + max(0.1, ttl / 3)

        self._ka_thread = threading.Thread(
            target=_loop, name="name-resolve-keepalive", daemon=True
        )
        self._ka_thread.start()

    def delete(self, name: str):
        resp = self._call({"op": "delete", "key": name})
        self._to_delete.discard(name)
        self._keepalive.pop(name, None)
        if not resp["ok"]:
            raise NameEntryNotFoundError(name)

    def clear_subtree(self, name_root: str):
        self._call({"op": "clear_subtree", "key": name_root})

    def get(self, name: str) -> str:
        resp = self._call({"op": "get", "key": name})
        if not resp["ok"]:
            raise NameEntryNotFoundError(name)
        return resp["value"]

    def get_subtree(self, name_root: str) -> List[str]:
        return self._call({"op": "get_subtree", "key": name_root})["values"]

    def find_subtree(self, name_root: str) -> List[str]:
        return self._call({"op": "get_subtree", "key": name_root})["keys"]

    def reset(self):
        self._stop.set()
        if self._ka_thread is not None:
            self._ka_thread.join(timeout=2)
        for name in list(self._to_delete):
            try:
                self.delete(name)
            except (NameEntryNotFoundError, TimeoutError, zmq.ZMQError):
                pass
        self._to_delete.clear()
        self._keepalive.clear()
        # the repository stays usable: a later add with a TTL restarts the
        # keepalive thread
        self._stop = threading.Event()
        self._ka_thread = None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="areal_tpu_torch name-resolve server")
    p.add_argument("--port", type=int, default=7777)
    p.add_argument("--host", default="0.0.0.0")
    args = p.parse_args(argv)
    server = NameResolveServer(port=args.port, host=args.host)
    logger.info("name-resolve server on %s:%d", args.host, server.port)
    server.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
