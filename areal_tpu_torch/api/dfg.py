"""Dataflow graph of Model Function Calls.

Rebuild of the reference's MFC graph layer (reference: realhf/api/core/dfg.py
— ``MFCDef`` :56, ``build_graph`` :237): one experiment = a DAG of
generate / inference / train_step calls on named models; edges are derived
by matching producers' output keys to consumers' input keys.

Hooks mirror the reference's ``ParamReallocHook``/``OffloadHook``; on TPU a
param-realloc hook is a resharding request (``jax.device_put`` onto the
target NamedSharding) rather than an NCCL bcast plan.

The port's copy of ``areal_tpu/api/dfg.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

from areal_tpu_torch.api.config import (
    ModelAbstraction,
    ModelInterfaceAbstraction,
    ModelName,
)
from areal_tpu_torch.api.data import MicroBatchSpec


class ModelInterfaceType(enum.Enum):
    GENERATE = "generate"
    TRAIN_STEP = "train_step"
    EVALUATE = "evaluate"
    INFERENCE = "inference"


@dataclasses.dataclass
class MFCHook:
    """Base class for pre/post hooks attached to an MFC."""


@dataclasses.dataclass
class ParamReallocHook(MFCHook):
    """Re-host weights under a different model name / layout before or after
    the call (reference: dfg.py ``ParamReallocHook``; used for trainer->ref
    EMA updates and train<->gen layout moves)."""

    source: Optional[ModelName] = None
    target: Optional[ModelName] = None
    eta: float = 1.0  # target = eta * source + (1 - eta) * target

    def __post_init__(self):
        assert (self.source is None) != (self.target is None), (
            "exactly one of source/target must be set"
        )


@dataclasses.dataclass
class OffloadHook(MFCHook):
    """Drop device copies of the model after the call (host copy kept)."""


@dataclasses.dataclass
class MFCDef:
    """One node of the experiment dataflow graph.

    ``n_seqs`` is the number of sequences the master accumulates in the
    buffer before this call fires; ``input_keys``/``output_keys`` define the
    graph edges by name matching.
    """

    name: str
    model_name: ModelName
    interface_type: ModelInterfaceType
    interface_impl: ModelInterfaceAbstraction
    input_keys: Tuple[str, ...] = ()
    output_keys: Tuple[str, ...] = ()
    n_seqs: int = 1
    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)
    balanced_dp: bool = False
    log_return_value: bool = False
    model_type: Optional[Any] = None
    model_path: Optional[str] = None
    pre_hooks: List[MFCHook] = dataclasses.field(default_factory=list)
    post_hooks: List[MFCHook] = dataclasses.field(default_factory=list)

    # filled by build_graph
    _G: Any = None

    def __post_init__(self):
        self.input_keys = tuple(self.input_keys)
        self.output_keys = tuple(self.output_keys)
        dup = set(self.input_keys) & set(self.output_keys)
        if dup:
            raise ValueError(
                f"MFC {self.name}: keys {dup} are both input and output"
            )

    @property
    def role(self) -> str:
        return self.model_name.role

    @property
    def G(self):
        assert self._G is not None, "call build_graph first"
        return self._G

    @property
    def parents(self) -> List["MFCDef"]:
        return [self.G.nodes[p]["object"] for p in self.G.predecessors(self.name)]

    @property
    def children(self) -> List["MFCDef"]:
        return [self.G.nodes[c]["object"] for c in self.G.successors(self.name)]

    @property
    def is_src(self) -> bool:
        return self.G.in_degree(self.name) == 0

    @property
    def is_dst(self) -> bool:
        return self.G.out_degree(self.name) == 0

    @property
    def data_producers(self) -> Dict[str, Optional[str]]:
        """key -> producing MFC name (None if from the dataset)."""
        out = {}
        for k in self.input_keys:
            out[k] = None
            for _, node in self.G.nodes(data="object"):
                if node.name != self.name and k in node.output_keys:
                    out[k] = node.name
        return out

    def __repr__(self):
        return f"MFCDef[{self.name}:{self.model_name}:{self.interface_type.value}]"


def build_graph(rpcs: List[MFCDef], verbose: bool = False):
    """Wire MFCs into a networkx DiGraph by output->input key matching.
    Attaches the graph to every node and returns it."""
    import networkx as nx

    names = [r.name for r in rpcs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate MFC names: {names}")

    G = nx.DiGraph()
    for r in rpcs:
        G.add_node(r.name, object=r)
    for dst in rpcs:
        for key in dst.input_keys:
            for src in rpcs:
                if src.name != dst.name and key in src.output_keys:
                    if G.has_edge(src.name, dst.name):
                        G.edges[src.name, dst.name]["keys"].append(key)
                    else:
                        G.add_edge(src.name, dst.name, keys=[key])
    if not nx.is_directed_acyclic_graph(G):
        raise ValueError("MFC graph has a cycle")
    for r in rpcs:
        r._G = G
    if verbose:
        from areal_tpu_torch.base import logging_

        logging_.getLogger("dfg").info(
            "MFC graph: nodes=%s edges=%s",
            list(G.nodes),
            [(u, v, d["keys"]) for u, v, d in G.edges(data=True)],
        )
    return G
