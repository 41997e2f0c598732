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

Beside each full-precision snapshot a publisher may write the int8
serving tree (:func:`save_quantized_params`, ``models/quantize.py``) into
a sibling directory (:func:`quant_snapshot_path`) and advertise it in the
manifest (``serving_quant``, :func:`quant_manifest_entry`).  Serving from
it is not ported yet (ROADMAP.md queue 1, item 8).

Train-state checkpoints (:func:`save_train_state`) hold the trainer's
float32 master parameters, its optimizer's moments and step count, and
the version, in one safetensors file with a manifest.  Each moment is
kept as the optimizer stores it: in its own dtype (``mu_dtype``,
``nu_dtype``), and a factored second moment as its ``r`` and ``c``
vectors under the parameter's key path.  A restore requires the same
kinds (key paths, shapes and dtypes) and copies them bit for bit.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("checkpoint")

#: filename of the layout/dtype manifest published inside a snapshot dir
MANIFEST_NAME = "areal_manifest.json"
#: filename of the snapshot's tensors inside a snapshot dir
TENSORS_NAME = "params.safetensors"
#: filename of a train-state checkpoint's tensors inside its dir
TRAIN_STATE_NAME = "train_state.safetensors"
#: suffix of the sibling snapshot dir holding a version's int8 serving
#: tree (``v7`` -> ``v7-int8``): a sibling, not a subdir, so the base
#: snapshot stays as it is for consumers that ignore the quantized format;
#: the publisher's keep-last-2 GC reaps the pair together
QUANT_DIR_SUFFIX = "-int8"

_INT_DTYPE = re.compile(r"u?int\d+$")

#: background writes of ``save_params(..., wait=False)``: (thread, error box)
_pending_saves: List[Tuple[threading.Thread, List[Exception]]] = []
#: the same for the optional int8 trees of ``save_quantized_params``, kept
#: apart so a failed int8 write never holds back the full-precision publish
_pending_quant_saves: List[Tuple[threading.Thread, List[Exception]]] = []
_pending_lock = threading.Lock()


def quant_snapshot_path(path: str) -> str:
    """The sibling dir a snapshot's int8 serving tree publishes to."""
    return os.path.abspath(path) + QUANT_DIR_SUFFIX


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


def _write_in_background(flat, path: str, pending) -> None:
    errors: List[Exception] = []

    def write():
        try:
            _write_tensors(flat, path)
        except Exception as e:  # noqa: BLE001 - raised by the waiter
            errors.append(e)

    t = threading.Thread(target=write, daemon=True, name="save-params")
    t.start()
    with _pending_lock:
        pending.append((t, errors))


def _wait(pending) -> None:
    with _pending_lock:
        waiting = list(pending)
        pending.clear()
    failed = None
    for t, errors in waiting:
        t.join()
        if errors and failed is None:
            failed = errors[0]
    if failed is not None:
        raise failed


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
    _write_in_background(flat, path, _pending_saves)


def save_quantized_params(params, path: str, cast_dtype=None,
                          wait: bool = True):
    """Publish a snapshot's int8 serving tree (matmul weights as int8 plus
    per-output-channel float32 absmax scales, everything else cast to
    ``cast_dtype``; ``models/quantize.py``) as its own snapshot at
    ``path``, conventionally :func:`quant_snapshot_path` of the
    full-precision one.

    The quantization runs on the parameters' device before this returns,
    and the host copies are taken then, so the caller may go on updating
    ``params``; ``wait=False`` writes the file on a background thread
    (:func:`wait_for_quant_saves`).  Returns the int8 tree's layout (the
    manifest's ``serving_quant`` leaves, :func:`quant_manifest_entry`), or
    None when nothing in the tree is quantizable."""
    from areal_tpu_torch.models import quantize

    path = os.path.abspath(path)
    with torch.no_grad():
        if cast_dtype is not None:
            params = _tree_map(lambda t: t.detach().to(cast_dtype), params)
        qtree = quantize.quantize_param_tree(params)
    if not quantize.quantized_leaf_count(qtree):
        return None
    os.makedirs(path, exist_ok=True)
    flat = _snapshot(qtree, None)
    if wait:
        _write_tensors(flat, path)
    else:
        _write_in_background(flat, path, _pending_quant_saves)
    return _rebuild(qtree, {
        k: torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
        for k, t in flat.items()
    })


def wait_for_saves():
    """Block until every pending background save has landed; raises the
    first one's failure."""
    _wait(_pending_saves)


def wait_for_quant_saves():
    """Block until every pending int8-tree save has landed; raises the
    first one's failure.  Kept apart from :func:`wait_for_saves` so the
    optional int8 publish can fail without taking the full-precision
    advertisement with it."""
    _wait(_pending_quant_saves)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


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
    ``os.replace`` of a per-process temporary file.

    ``serving_quant`` advertises the quantized serving trees the publisher
    also wrote: ``{"int8": quant_manifest_entry(...)}``."""
    manifest = {"version": version, "leaves": _leaves_meta(params)}
    if serving_quant:
        manifest["serving_quant"] = serving_quant
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


def quant_manifest_entry(quant_avals, path: str) -> Dict:
    """The manifest's ``serving_quant`` advertisement of one quantized
    tree: the sibling dir's name (resolved against the base snapshot's
    parent at restore time) and its leaf layout."""
    return {
        "dir": os.path.basename(os.path.abspath(path)),
        "leaves": _leaves_meta(quant_avals),
    }


def _state_tree(engine) -> Dict[str, Any]:
    """The train state as one tree: float32 master parameters and, with
    Adam, its moments, each under its parameter's key path (the optimizer
    keeps them in the engine's leaf order; a factored second moment is a
    ``{"r", "c"}`` subtree there)."""
    tree: Dict[str, Any] = {"params": engine.params}
    if getattr(engine.opt, "mu", None) is not None:

        def like_params(moments):
            it = iter(moments)
            return _tree_map(lambda _: next(it), engine.params)

        tree["opt_state"] = {
            "mu": like_params(engine.opt.mu), "nu": like_params(engine.opt.nu)
        }
    return tree


def save_train_state(engine, path: str):
    """Write a :class:`~areal_tpu_torch.engine.train_engine.TrainEngine`'s
    train state into the directory ``path``: its float32 master
    parameters, optimizer moments and update count, and its version, as one
    safetensors file (:data:`TRAIN_STATE_NAME`) and a manifest.  Both land
    by ``os.replace``, the manifest last, so a dir with a manifest is
    whole."""
    from safetensors.torch import save_file

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tree = _state_tree(engine)
    flat = _snapshot(tree, None)
    count = engine.opt.count if engine.opt is not None else 0
    tmp = os.path.join(path, f"{TRAIN_STATE_NAME}.tmp.{os.getpid()}")
    save_file(flat, tmp, metadata={
        "format": "pt",
        "version": str(int(engine.version)),
        "opt_count": str(int(count)),
    })
    os.replace(tmp, os.path.join(path, TRAIN_STATE_NAME))
    write_manifest(tree, path, version=int(engine.version))
    logger.info("saved train state (v%d) -> %s", engine.version, path)


def load_train_state(engine, path: str) -> bool:
    """Restore a checkpoint written by :func:`save_train_state` into the
    engine's tensors in place (parameters, moments) and set its version
    and update count.  Returns False when ``path`` holds no checkpoint;
    raises when its layout does not match the engine's."""
    from safetensors import safe_open

    path = os.path.abspath(path)
    manifest = read_manifest(path)
    fname = os.path.join(path, TRAIN_STATE_NAME)
    if manifest is None or not os.path.exists(fname):
        return False
    tree = _state_tree(engine)
    problems = validate_manifest(tree, manifest)
    # a train state restores unchanged: no float width is cast either
    problems += [
        f"dtype mismatch at {k}: engine {v['dtype']} vs snapshot "
        f"{manifest['leaves'][k].get('dtype')}"
        for k, v in _leaves_meta(tree).items()
        if k in manifest["leaves"]
        and manifest["leaves"][k].get("dtype") != v["dtype"]
    ]
    if problems:
        raise ValueError(
            f"train state at {path} does not match the engine: "
            + "; ".join(problems[:5])
        )
    with safe_open(fname, framework="pt", device="cpu") as f:
        meta = f.metadata()
        with torch.no_grad():
            for kp, leaf in _flatten(tree):
                leaf.copy_(f.get_tensor("/".join(kp)))
    engine.version = int(meta["version"])
    if engine.opt is not None:
        engine.opt.count = int(meta["opt_count"])
    logger.info("restored train state (v%d) <- %s", engine.version, path)
    return True


def latest_train_state(
    base_dir: str, max_step: Optional[int] = None
) -> Optional[str]:
    """The ``globalstepN`` checkpoint dir under ``base_dir`` with the
    highest step number, optionally capped at ``max_step``.  Selection is
    by the step in the name, not by modification time."""
    if not os.path.isdir(base_dir):
        return None
    best: Optional[str] = None
    best_step = -1
    for d in os.listdir(base_dir):
        full = os.path.join(base_dir, d)
        if not os.path.isdir(full) or "tmp" in d:
            continue
        m = re.fullmatch(r"globalstep(\d+)", d)
        if m is None:
            continue
        step = int(m.group(1))
        if max_step is not None and step > max_step:
            continue
        if step > best_step:
            best, best_step = full, step
    return best
