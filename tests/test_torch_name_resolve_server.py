"""The port's name-resolve service (``areal_tpu_torch/base/name_resolve_server.py``)
against the JAX package's: the cases of ``tests/base/test_name_resolve_server.py``
(round trip, subtrees, sub-entries and waits, TTL expiry, keepalive, reset
of owned keys) run on every pairing of the two packages' servers and
clients, the port's with the port's and each package's client against the
other package's server, and must give the same answers; the wire format
is the same JSON.  ``reconfigure("server")`` plumbs the port's global
repository to a server, and the refusal it used to raise is gone."""

import time

import pytest
import torch

from areal_tpu.base import name_resolve as jnr
from areal_tpu.base import name_resolve_server as jnrs
from areal_tpu_torch.base import name_resolve as tnr
from areal_tpu_torch.base import name_resolve_server as tnrs

PKGS = {"jax": (jnr, jnrs), "torch": (tnr, tnrs)}
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def roundtrip(server, client, errors):
    repo = client(server)
    repo.add("a/b/c", "v1")
    out = [repo.get("a/b/c")]
    with pytest.raises(errors.NameEntryExistsError):
        repo.add("a/b/c", "v2")
    repo.add("a/b/c", "v2", replace=True)
    out.append(repo.get("a/b/c"))
    repo.delete("a/b/c")
    with pytest.raises(errors.NameEntryNotFoundError):
        repo.get("a/b/c")
    with pytest.raises(errors.NameEntryNotFoundError):
        repo.delete("a/b/c")
    repo.reset()
    assert out == ["v1", "v2"]


def subtree(server, client, errors):
    repo = client(server)
    repo.add("root/x", "1")
    repo.add("root/y", "2")
    repo.add("rootling", "3")  # a sibling, not under root/
    assert repo.get_subtree("root") == ["1", "2"]
    assert repo.find_subtree("root") == ["root/x", "root/y"]
    repo.clear_subtree("root")
    assert repo.get_subtree("root") == []
    assert repo.get("rootling") == "3"
    repo.reset()


def subentry_and_wait(server, client, errors):
    repo = client(server)
    sub = repo.add_subentry("workers", "w0")
    assert sub.startswith("workers/")
    assert repo.wait(sub, timeout=1) == "w0"
    with pytest.raises(TimeoutError):
        repo.wait("never", timeout=0.2, poll_frequency=0.05)
    repo.reset()


def ttl_expiry(server, client, errors):
    repo = client(server)
    # no keepalive thread: the request goes to the server as it is
    repo._call({"op": "add", "key": "ephemeral", "value": "x", "ttl": 0.2})
    assert repo.get("ephemeral") == "x"
    time.sleep(0.5)
    with pytest.raises(errors.NameEntryNotFoundError):
        repo.get("ephemeral")
    repo.reset()


def keepalive(server, client, errors):
    repo = client(server)
    repo.add("hb/w0", "alive", keepalive_ttl=0.4)
    time.sleep(1.2)  # several TTLs: the keepalive thread refreshed it
    assert repo.get("hb/w0") == "alive"
    repo.reset()  # stops the keepalive and deletes the key
    with pytest.raises(errors.NameEntryNotFoundError):
        client(server).get("hb/w0")


def reset_owned(server, client, errors):
    r1, r2 = client(server), client(server)
    r1.add("mine", "1")
    r2.add("theirs", "2", delete_on_exit=False)
    r1.reset()
    with pytest.raises(errors.NameEntryNotFoundError):
        r2.get("mine")
    assert r2.get("theirs") == "2"
    r2.reset()


CASES = [roundtrip, subtree, subentry_and_wait, ttl_expiry, keepalive,
         reset_owned]


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS,
                         ids=[f"{s}-server-{c}-client" for s, c in PAIRS])
@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_name_resolve_server(case, server_pkg, client_pkg):
    errors, client_mod = PKGS[client_pkg]
    server = PKGS[server_pkg][1].NameResolveServer(
        port=0, host="127.0.0.1").start()
    try:
        case(server, lambda s: client_mod.ServerNameRecordRepository(
            f"127.0.0.1:{s.port}"), errors)
    finally:
        server.stop()


def test_reconfigure_server_backend(monkeypatch):
    """``reconfigure("server")`` takes the address as an argument or from
    ``AREAL_NAME_RESOLVE_ADDR``, and refuses to go without one."""
    server = tnrs.NameResolveServer(port=0, host="127.0.0.1").start()
    try:
        repo = tnr.reconfigure("server", address=f"127.0.0.1:{server.port}")
        assert isinstance(repo, tnrs.ServerNameRecordRepository)
        tnr.add("via/global", "ok", delete_on_exit=False)
        assert tnr.get("via/global") == "ok"
        # reconfiguring resets the old repository: its owned keys go
        tnr.add("owned", "1")
        monkeypatch.setenv("AREAL_NAME_RESOLVE_ADDR",
                           f"127.0.0.1:{server.port}")
        tnr.reconfigure("server")
        assert tnr.get("via/global") == "ok"
        with pytest.raises(tnr.NameEntryNotFoundError):
            tnr.get("owned")
        monkeypatch.delenv("AREAL_NAME_RESOLVE_ADDR")
        with pytest.raises(ValueError, match="AREAL_NAME_RESOLVE_ADDR"):
            tnr.reconfigure("server")
    finally:
        # later tests in this process must not keep a repository aimed at a
        # stopped server
        tnr.reconfigure("memory")
        server.stop()
