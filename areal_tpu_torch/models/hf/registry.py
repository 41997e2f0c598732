"""HF checkpoint import and export (port of
``areal_tpu/models/hf/registry.py``).

Each family provides config conversion (HF ``config.json`` <->
:class:`TransformerConfig`) and parameter conversion (an HF state dict <->
the port's tree, whose ``layers`` is a list of per-layer dicts).  Loading
reads the safetensors shards (or ``pytorch_model*.bin`` files) of a
directory one tensor at a time, through ``safetensors``' torch framework,
so bf16 checkpoints load without numpy's help (numpy has a bfloat16 only
where ml_dtypes registered one) and no second full copy of the checkpoint
is built on the host.
Saving writes what the reference writes: float32 tensors under the same
names, sharded at :data:`MAX_SHARD_BYTES` with an index file, and the same
``config.json``; a directory saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from areal_tpu_torch.base import logging_
from areal_tpu_torch.base.device import DeviceLike, resolve_device
from areal_tpu_torch.models.config import TransformerConfig

logger = logging_.getLogger("hf_registry")

Params = Dict[str, Any]
#: what a family's ``params_to_hf`` returns: HF names to tensors, in the
#: order the reference writes them (which fixes how they are sharded)
StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass
class HFFamily:
    name: str
    hf_architecture: str
    config_from_hf: Callable[[Dict[str, Any]], TransformerConfig]
    config_to_hf: Callable[[TransformerConfig], Dict[str, Any]]
    params_from_hf: Callable[["CheckpointReader", TransformerConfig], Params]
    params_to_hf: Callable[[Params, TransformerConfig], StateDict]


_FAMILIES: Dict[str, HFFamily] = {}
_BY_ARCH: Dict[str, str] = {}
#: the reference's mixture-of-experts families, not ported yet
_MOE_FAMILIES = {"MixtralForCausalLM": "mixtral",
                 "Qwen3MoeForCausalLM": "qwen3_moe"}


def _moe_not_ported(what: str) -> NotImplementedError:
    from areal_tpu_torch.engine.inference_server import _not_ported

    return _not_ported(f"the mixture-of-experts HF family {what}", item=9)


def register_hf_family(family: HFFamily):
    if family.name in _FAMILIES:
        raise KeyError(f"hf family {family.name} already registered")
    _FAMILIES[family.name] = family
    _BY_ARCH[family.hf_architecture] = family.name


def get_hf_family(name: str) -> HFFamily:
    import areal_tpu_torch.models.hf  # noqa: F401 ensure registration

    if name in _MOE_FAMILIES.values():
        raise _moe_not_ported(repr(name))
    return _FAMILIES[name]


def family_from_architecture(arch: str) -> HFFamily:
    if arch in _MOE_FAMILIES:
        raise _moe_not_ported(arch)
    if arch not in _BY_ARCH:
        raise KeyError(f"no HF family for architecture {arch!r}; known: "
                       f"{sorted(_BY_ARCH)}")
    return _FAMILIES[_BY_ARCH[arch]]


class CheckpointReader:
    """The tensors of an HF checkpoint directory by name, each read when it
    is asked for: from ``model.safetensors``, from the shards that
    ``model.safetensors.index.json`` names, or else from the
    ``pytorch_model*.bin`` files.  :meth:`get` returns a leaf as float32 on
    the reader's device (the reference's float32 tree)."""

    def __init__(self, path: str, device: torch.device):
        self.device = device
        self._where: Dict[str, Any] = {}  # name -> safe_open handle or dict
        self.bytes_read = 0
        index = os.path.join(path, "model.safetensors.index.json")
        single = os.path.join(path, "model.safetensors")
        if os.path.isfile(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            for shard in sorted(set(weight_map.values())):
                self._open_safetensors(os.path.join(path, shard))
        elif os.path.isfile(single):
            self._open_safetensors(single)
        else:
            for fn in sorted(os.listdir(path)):
                if fn.startswith("pytorch_model") and fn.endswith(".bin"):
                    sd = torch.load(os.path.join(path, fn), map_location="cpu",
                                    weights_only=True, mmap=True)
                    self._where.update((k, sd) for k in sd)
            if not self._where:
                raise FileNotFoundError(f"no model weights found in {path}")

    def _open_safetensors(self, file: str):
        from safetensors import safe_open

        handle = safe_open(file, framework="pt", device="cpu")
        self._where.update((k, handle) for k in handle.keys())

    def keys(self) -> List[str]:
        return list(self._where)

    def get(self, name: str, transpose: bool = False) -> torch.Tensor:
        """``name`` as a contiguous float32 tensor on the device, moved in
        its stored dtype and widened there; ``transpose`` turns a torch
        ``[out, in]`` matrix into the port's ``[in, out]``."""
        src = self._where[name]
        t = src[name] if isinstance(src, dict) else src.get_tensor(name)
        self.bytes_read += t.numel() * t.element_size()
        t = t.to(self.device).float()
        return (t.t() if transpose else t).contiguous()


class _StateReader(CheckpointReader):
    """An exported state dict read back as a checkpoint, on the meta
    device: shapes only, nothing copied."""

    def __init__(self, state: StateDict):
        self.device = torch.device("meta")
        self._where = {k: state for k in state}
        self.bytes_read = 0


def load_hf_config(path: str) -> Tuple[HFFamily, TransformerConfig, Dict]:
    """The family, the port's config and the raw ``config.json`` of an HF
    directory; reads no tensor."""
    import areal_tpu_torch.models.hf  # noqa: F401

    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    arch = (hf_cfg.get("architectures") or ["?"])[0]
    family = family_from_architecture(arch)
    return family, family.config_from_hf(hf_cfg), hf_cfg


def load_hf_model(
    path: str,
    is_critic: bool = False,
    dtype: Optional[str] = None,
    device: DeviceLike = None,
) -> Tuple[TransformerConfig, Params]:
    """Load an HF checkpoint directory into ``(config, params)``: float32
    leaves on ``device`` (default ``cuda``), the trainer's master weights;
    for serving, pass them through
    :func:`areal_tpu_torch.models.convert.serving_params`.  ``dtype``
    replaces the config's activation dtype.  ``is_critic=True`` (a value
    head) is refused: critics are not ported."""
    if is_critic:
        from areal_tpu_torch.engine.inference_server import _not_ported

        raise _not_ported("critic models from an HF checkpoint "
                          "(is_critic=True)", item=7)
    device = resolve_device(device)
    family, cfg, _ = load_hf_config(path)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    state = CheckpointReader(path, device)
    params = family.params_from_hf(state, cfg)
    logger.info(
        "loaded %s (%d layers, %d hidden) from %s: %.3f GB read",
        family.name, cfg.n_layers, cfg.hidden_dim, path,
        state.bytes_read / 1e9,
    )
    return cfg, params


#: the largest shard ``save_hf_model`` writes (the reference's)
MAX_SHARD_BYTES = 4 * 1024**3


def _shards(state: StateDict) -> List[List[str]]:
    """The reference's greedy split of the names, in order, by float32
    bytes."""
    shards: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for k, v in state.items():
        n = v.numel() * 4
        if cur and cur_bytes + n > MAX_SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = [], 0
        cur.append(k)
        cur_bytes += n
    if cur:
        shards.append(cur)
    return shards


#: TransformerConfig fields of a run, not of the architecture: config.json
#: does not carry them
_RUN_FIELDS = ("dtype", "logits_dtype", "remat", "remat_policy")


def _leaf_shapes(tree, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tuple(tree.shape)}
    out: Dict[str, Tuple[int, ...]] = {}
    for k, v in items:
        out.update(_leaf_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _check_export(family: HFFamily, cfg: TransformerConfig, params: Params,
                  state: StateDict):
    """Refuse an export that would load as another model: ``config.json``
    must give ``cfg`` back, and the tensors every leaf of ``params``."""
    run = {k: getattr(cfg, k) for k in _RUN_FIELDS}
    back = dataclasses.replace(
        family.config_from_hf(family.config_to_hf(cfg)), **run)
    if back != cfg:
        diff = {f.name: (getattr(cfg, f.name), getattr(back, f.name))
                for f in dataclasses.fields(cfg)
                if getattr(cfg, f.name) != getattr(back, f.name)}
        raise ValueError(
            f"the {family.name} family's config.json cannot carry this "
            f"model: {diff} (the model's value, the reloaded one)")
    want = _leaf_shapes(params)
    got = _leaf_shapes(family.params_from_hf(_StateReader(state), cfg))
    if got != want:
        bad = sorted(k for k in set(want) | set(got)
                     if want.get(k) != got.get(k))
        raise ValueError(
            f"the {family.name} family's export does not give back the "
            f"model's parameters at {bad[:8]} ({len(bad)} leaves differ)")


def _host_f32(state: StateDict, names: List[str]) -> Iterator:
    for k in names:
        yield k, state[k].detach().to("cpu", torch.float32).contiguous()


def save_hf_model(
    path: str,
    family_name: str,
    cfg: TransformerConfig,
    params: Params,
    tokenizer=None,
):
    """Export to an HF checkpoint directory (``config.json`` and float32
    safetensors, sharded with an index file above
    :data:`MAX_SHARD_BYTES`).  ``params`` is the port's tree of tensors on
    any device; one shard at a time is copied to the host.  A model that
    the family's files cannot hold (its ``config.json`` would reload as
    another config, or a leaf is not exported) raises ``ValueError``
    before anything is written."""
    from safetensors.torch import save_file

    family = get_hf_family(family_name)
    with torch.no_grad():
        state = family.params_to_hf(params, cfg)
        _check_export(family, cfg, params, state)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(family.config_to_hf(cfg), f, indent=2)
    shards = _shards(state)
    meta = {"format": "pt"}
    if len(shards) == 1:
        save_file(dict(_host_f32(state, shards[0])),
                  os.path.join(path, "model.safetensors"), metadata=meta)
    else:
        weight_map = {}
        for i, names in enumerate(shards):
            fn = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            save_file(dict(_host_f32(state, names)), os.path.join(path, fn),
                      metadata=meta)
            weight_map.update((k, fn) for k in names)
        total = sum(v.numel() * 4 for v in state.values())
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f)
    if tokenizer is not None:
        tokenizer.save_pretrained(path)
