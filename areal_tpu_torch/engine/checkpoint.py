"""Raw-parameter snapshots for the train->generation weight path (port of
the serving half of ``areal_tpu/engine/checkpoint.py``).

A snapshot is a directory holding one ``safetensors`` file of the
parameter tree, each leaf under its "/"-joined key path (the port keeps
layers as a list, so a layer's leaves are ``layers/<i>/...``), and a
layout manifest (:data:`MANIFEST_NAME`) that consumers check their restore
template against before they read any tensor.  Both files land by
``os.replace`` of a private temporary file, so a reader never sees a torn
one.  The JAX package writes orbax trees instead; a snapshot written by
the port is read only by the port.

Not ported yet: the quantized sibling tree of int8 serving weights
(ROADMAP.md queue 1, item 8) and train-state checkpoints (the trainer's
params, optimizer state and version).
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from areal_tpu_torch.engine.inference_server import _not_ported

#: filename of the layout/dtype manifest published inside a snapshot dir
MANIFEST_NAME = "areal_manifest.json"
#: filename of the snapshot's tensors inside a snapshot dir
TENSORS_NAME = "params.safetensors"

_INT_DTYPE = re.compile(r"u?int\d+$")

#: background writes of ``save_params(..., wait=False)``: (thread, error box)
_pending_saves: List[Tuple[threading.Thread, List[Exception]]] = []
_pending_lock = threading.Lock()


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(key path, leaf)`` pairs: dict keys in sorted order, list items by
    index (their index is their key)."""
    if isinstance(tree, dict):
        out: List[Tuple[Tuple[str, ...], Any]] = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, prefix + (str(i),)))
        return out
    return [(prefix, tree)]


def _rebuild(template, lookup: Dict[str, torch.Tensor], prefix=()):
    """``template``'s structure with each leaf taken from ``lookup`` by key
    path."""
    if isinstance(template, dict):
        return {k: _rebuild(v, lookup, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_rebuild(v, lookup, prefix + (str(i),))
                for i, v in enumerate(template)]
    return lookup["/".join(prefix)]


def _dtype_name(leaf) -> str:
    dt = getattr(leaf, "dtype", torch.float32)
    return str(dt).replace("torch.", "")


def _nbytes(leaf) -> int:
    return int(leaf.numel() * leaf.element_size())


def _snapshot(params, cast_dtype) -> Dict[str, torch.Tensor]:
    """Host copies of every leaf, cast on the device first (half the
    bytes to move for a bfloat16 cast of float32 weights)."""
    flat = {}
    for kp, leaf in _flatten(params):
        t = leaf.detach()
        if cast_dtype is not None:
            t = t.to(dtype=cast_dtype)
        flat["/".join(kp)] = t.to("cpu", copy=True).contiguous()
    return flat


def _write_tensors(flat: Dict[str, torch.Tensor], path: str):
    from safetensors.torch import save_file

    tmp = os.path.join(path, f"{TENSORS_NAME}.tmp.{os.getpid()}")
    save_file(flat, tmp, metadata={"format": "pt"})
    os.replace(tmp, os.path.join(path, TENSORS_NAME))


def save_params(params, path: str, cast_dtype=None, wait: bool = True):
    """Publish a parameter tree as a snapshot in the directory ``path``.
    ``cast_dtype`` (e.g. ``torch.bfloat16``) casts every leaf, which halves
    the bytes when the consumer serves at reduced precision anyway.

    ``wait=False`` returns once every leaf is copied to the host (the
    caller may go on updating ``params`` in place) and writes the file on
    a background thread; call :func:`wait_for_saves` before advertising
    the snapshot."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    flat = _snapshot(params, cast_dtype)
    if wait:
        _write_tensors(flat, path)
        return
    errors: List[Exception] = []

    def write():
        try:
            _write_tensors(flat, path)
        except Exception as e:  # noqa: BLE001 - raised by wait_for_saves
            errors.append(e)

    t = threading.Thread(target=write, daemon=True, name="save-params")
    t.start()
    with _pending_lock:
        _pending_saves.append((t, errors))


def wait_for_saves():
    """Block until every pending background save has landed; raises the
    first one's failure."""
    with _pending_lock:
        pending = list(_pending_saves)
        _pending_saves.clear()
    failed = None
    for t, errors in pending:
        t.join()
        if errors and failed is None:
            failed = errors[0]
    if failed is not None:
        raise failed


def _open(path: str):
    from safetensors import safe_open

    return safe_open(
        os.path.join(os.path.abspath(path), TENSORS_NAME), framework="pt",
        device="cpu",
    )


def _restore_leaf(key: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A snapshot leaf on ``like``'s device in ``like``'s dtype."""
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(
            f"shape mismatch at {key}: template {list(like.shape)} vs "
            f"snapshot {list(t.shape)}"
        )
    return t.to(device=like.device, dtype=like.dtype)


def load_params_like(template, path: str):
    """Restore a snapshot written by :func:`save_params` onto
    ``template``'s structure, devices and dtypes (a float snapshot casts to
    the template's float width)."""
    with _open(path) as f:
        lookup = {
            "/".join(kp): _restore_leaf(
                "/".join(kp), f.get_tensor("/".join(kp)), leaf)
            for kp, leaf in _flatten(template)
        }
    return _rebuild(template, lookup)


#: safetensors' dtype codes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
#: the least size of each of a staged restore's two host buffers
_MIN_STAGE_BUFFER = 1 << 20


def load_params_staged(template, path: str, chunk_bytes: Optional[int] = None):
    """Restore a snapshot onto ``template``'s devices and dtypes with at
    most ``chunk_bytes`` of host memory (two buffers of half of it, at
    least 1 MiB each), straight onto the template's device.
    ``chunk_bytes=None`` (or <= 0) restores in one shot
    (:func:`load_params_like`), with the same result.

    The restore runs beside a serving loop on another thread, so it holds
    Python's lock and the card's copy queue as little as it can: each
    buffer is filled by ``readinto`` (which releases the lock) and, on a
    CUDA template, is page-locked and copied to the card asynchronously on
    the current stream while the next buffer fills.  Every leaf's shape is
    checked before any tensor is read; a float snapshot casts to the
    template's float width on the device."""
    if chunk_bytes is None or chunk_bytes <= 0:
        return load_params_like(template, path)
    leaves = [("/".join(kp), leaf) for kp, leaf in _flatten(template)]
    fname = os.path.join(os.path.abspath(path), TENSORS_NAME)
    with open(fname, "rb", buffering=0) as f:
        n_header = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n_header))
        base = 8 + n_header
        jobs = []  # (file offset, key, template leaf, meta)
        for key, like in leaves:
            meta = header.get(key)
            if meta is None:
                raise KeyError(f"{key} is not in the snapshot {fname}")
            if tuple(meta["shape"]) != tuple(like.shape):
                raise ValueError(
                    f"shape mismatch at {key}: template {list(like.shape)} "
                    f"vs snapshot {list(meta['shape'])}"
                )
            jobs.append((base + meta["data_offsets"][0], key, like, meta))
        jobs.sort(key=lambda j: j[0])
        cuda = any(like.device.type == "cuda" for _, like in leaves)
        size = max(chunk_bytes // 2, _MIN_STAGE_BUFFER)
        bufs = [torch.empty(size, dtype=torch.uint8, pin_memory=cuda)
                for _ in range(2)]
        views = [memoryview(b.numpy()) for b in bufs]
        done = [None, None]  # per buffer: the event of its last copies
        cur, used = 0, 0
        raws: Dict[str, torch.Tensor] = {}
        for off, key, like, meta in jobs:
            lo, hi = meta["data_offsets"]
            raw = torch.empty(hi - lo, dtype=torch.uint8, device=like.device)
            raws[key] = raw
            f.seek(off)
            pos = 0
            while pos < hi - lo:
                if used == size:
                    if cuda:
                        done[cur] = torch.cuda.Event()
                        done[cur].record()
                    cur, used = 1 - cur, 0
                    if done[cur] is not None:
                        done[cur].synchronize()  # its copies have landed
                n = min(hi - lo - pos, size - used)
                view = views[cur][used:used + n]
                got = 0
                while got < n:
                    k = f.readinto(view[got:])
                    if not k:
                        raise EOFError(f"{fname} ends inside {key}")
                    got += k
                raw[pos:pos + n].copy_(bufs[cur][used:used + n],
                                       non_blocking=cuda)
                pos += n
                used += n
        if cuda:
            # the buffers are freed on return: their last copies land first
            torch.cuda.current_stream().synchronize()
    lookup = {}
    for _, key, like, meta in jobs:
        t = raws.pop(key).view(_ST_DTYPES[meta["dtype"]]).view(like.shape)
        lookup[key] = t if t.dtype == like.dtype else t.to(like.dtype)
    return _rebuild(template, lookup)


def _leaves_meta(params) -> Dict[str, Dict]:
    """Per-leaf ``{"shape", "dtype"}`` keyed by "/"-joined key path: the
    manifest's layout vocabulary (dtype names as numpy spells them)."""
    return {
        "/".join(kp): {
            "shape": list(getattr(leaf, "shape", ())),
            "dtype": _dtype_name(leaf),
        }
        for kp, leaf in _flatten(params)
    }


def write_manifest(params, path: str, version: Optional[int] = None,
                   serving_quant: Optional[Dict] = None):
    """Publish a layout/dtype manifest inside a snapshot dir: per-leaf key
    path, shape and dtype, plus the version.  Consumers validate their
    restore template against it before reading any tensor, so a layout
    mismatch fails as one readable error.  The manifest lands by
    ``os.replace`` of a per-process temporary file."""
    if serving_quant:
        raise _not_ported("quantized serving trees (serving_quant)", item=8)
    manifest = {"version": version, "leaves": _leaves_meta(params)}
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{MANIFEST_NAME}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, MANIFEST_NAME))
    return manifest


def read_manifest(path: str) -> Optional[Dict]:
    """The manifest written by :func:`write_manifest`, or None when the
    snapshot has none or is gone."""
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def validate_manifest(template, manifest: Dict) -> List[str]:
    """Mismatches between ``template`` and a snapshot manifest, as readable
    strings (empty = compatible): leaves missing from the snapshot, leaves
    the template does not have, shape mismatches, and float/integer
    dtype-class mismatches.  A float-width difference is no problem: the
    restore casts (publishers write the serving dtype; consumers may hold
    float32)."""
    problems: List[str] = []
    mine = {
        "/".join(kp): (list(getattr(leaf, "shape", ())), _dtype_name(leaf))
        for kp, leaf in _flatten(template)
    }
    theirs = {
        k: (v["shape"], v.get("dtype", "float32"))
        for k, v in manifest.get("leaves", {}).items()
    }
    for k in sorted(set(mine) - set(theirs)):
        problems.append(f"missing from snapshot: {k}")
    for k in sorted(set(theirs) - set(mine)):
        problems.append(f"unexpected in snapshot: {k}")
    for k in sorted(set(mine) & set(theirs)):
        if mine[k][0] != theirs[k][0]:
            problems.append(
                f"shape mismatch at {k}: engine {mine[k][0]} vs "
                f"snapshot {theirs[k][0]}"
            )
            continue
        if bool(_INT_DTYPE.match(mine[k][1])) != bool(
            _INT_DTYPE.match(theirs[k][1])
        ):
            problems.append(
                f"dtype-class mismatch at {k}: engine {mine[k][1]} vs "
                f"snapshot {theirs[k][1]} (int storage never casts "
                "to/from float weights)"
            )
    return problems


def save_train_state(engine, path: str):
    raise _not_ported("train-state checkpoints (save_train_state)")


def load_train_state(engine, path: str) -> bool:
    raise _not_ported("train-state checkpoints (load_train_state)")


def save_quantized_params(params, path: str, cast_dtype=None,
                          wait: bool = True):
    raise _not_ported("quantized serving trees (save_quantized_params)",
                      item=8)
