"""SequenceSample, the packed-batch currency of the trainer (port of the
parts of ``areal_tpu/api/data.py`` that the train path calls).

Data lives on the host as numpy arrays, packed 1-D varlen per key; padding
to ``[B, T]`` happens only at the engine boundary
(:mod:`areal_tpu_torch.engine.batching`).  Each id may own several
sequences per key, hence ``seqlens[key]`` is a list (per id) of lists
(per sequence).  The reference's JSON wire codec is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np

from areal_tpu_torch.base import datapack


@dataclasses.dataclass
class MicroBatchSpec:
    """``n_mbs`` is the (minimum) number of micro-batches;
    ``max_tokens_per_mb`` bounds tokens per micro-batch."""

    n_mbs: int = 1
    max_tokens_per_mb: int = int(1e12)


@dataclasses.dataclass
class SequenceSplitSpec:
    """Contiguous partition of a batch: either ``partitions`` [(start,end)...]
    or ``sizes`` may be given; the other is derived."""

    partitions: Optional[List[Tuple[int, int]]] = None
    sizes: Optional[List[int]] = None

    def __post_init__(self):
        if self.partitions is None and self.sizes is None:
            raise ValueError("either sizes or partitions required")
        if self.partitions is not None:
            bound = 0
            for start, end in self.partitions:
                if start >= end:
                    raise ValueError(f"empty partition {start}-{end}")
                if start != bound:
                    raise ValueError(f"non-contiguous partition at {start}")
                bound = end
            derived = [e - s for s, e in self.partitions]
            if self.sizes is None:
                self.sizes = derived
            elif self.sizes != derived:
                raise ValueError("sizes inconsistent with partitions")
        else:
            offsets = np.cumsum([0] + list(self.sizes))
            self.partitions = [
                (int(offsets[i]), int(offsets[i + 1]))
                for i in range(len(self.sizes))
            ]


# Keys whose per-sequence length is 1 (scalars).
_SCALAR_KEYS = frozenset(
    [
        "seq_no_eos_mask",
        "loss_mask",
        "rewards",
        "base_scores",
        "task_ids",
        "version",
        "version_start",
        "version_end",
        "birth_time",
    ]
)
# Keys whose length equals the main sequence length.
_FULL_LEN_KEYS = frozenset(
    [
        "input_ids",
        "packed_input_ids",
        "packed_prompts",
        "prompt_mask",
        "values",
        "seq",
        "packed_seq",
    ]
)
# Keys with length seqlen - 1 (per-transition quantities).
_SHIFTED_KEYS = frozenset(
    [
        "packed_logprobs",
        "packed_ref_logprobs",
        "prox_logp",
        "logprobs",
        "ref_logprobs",
        "old_logp",
        "ref_logp",
        "advantages",
        "ppo_loss_mask",
        "kl_rewards",
        "returns",
    ]
)


def _resolve_seqlen_from_key(key: str, seqlens: List[int]) -> List[List[int]]:
    if key in _SCALAR_KEYS:
        return [[1] for _ in seqlens]
    if key in _FULL_LEN_KEYS:
        return [[int(s)] for s in seqlens]
    if key in _SHIFTED_KEYS:
        return [[int(s) - 1] for s in seqlens]
    raise NotImplementedError(
        f"cannot resolve seqlens for key {key!r}; construct SequenceSample "
        "explicitly instead of via from_default"
    )


@dataclasses.dataclass
class SequenceSample:
    keys: Set[str]
    trailing_shapes: Dict[str, Optional[Tuple[int, ...]]]
    dtypes: Dict[str, Optional[np.dtype]]
    ids: List[str]
    seqlens: Dict[str, List[List[int]]]
    data: Optional[Dict[str, Optional[np.ndarray]]] = None
    metadata: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.keys = set(self.keys)
        self.ids = [str(i) for i in self.ids]
        if len(self.ids) != len(set(self.ids)):
            raise ValueError(f"duplicate ids: {self.ids}")
        for k in self.keys:
            lens = self.seqlens[k]
            if len(lens) != len(self.ids):
                raise ValueError(
                    f"seqlens[{k}] has {len(lens)} entries for {len(self.ids)} ids"
                )
            if self.data is not None and self.data.get(k) is not None:
                total = sum(sum(l) for l in lens)
                if self.data[k].shape[0] != total:
                    raise ValueError(
                        f"data[{k}] first dim {self.data[k].shape[0]} != "
                        f"total seqlen {total}"
                    )

    @classmethod
    def from_default(
        cls,
        seqlens: Sequence[int],
        ids: Sequence[Hashable],
        data: Dict[str, Optional[np.ndarray]],
        metadata: Optional[Dict[str, List[Any]]] = None,
    ) -> "SequenceSample":
        """A sample where every id has a single sequence of the given main
        length; per-key lengths come from the key-name registry."""
        metadata = dict(metadata or {})
        for k, v in metadata.items():
            if not isinstance(v, list) or len(v) != len(seqlens):
                raise ValueError(
                    f"metadata {k!r} must be a list of len {len(seqlens)}"
                )
        if len(seqlens) and isinstance(seqlens[0], (list, tuple)):
            assert all(len(s) == 1 for s in seqlens)
            seqlens = [s[0] for s in seqlens]
        seqlens = [int(s) for s in seqlens]
        keys = set(data.keys())
        data = {
            k: (np.asarray(v) if v is not None else None) for k, v in data.items()
        }
        return cls(
            keys=keys,
            ids=list(ids),
            seqlens={k: _resolve_seqlen_from_key(k, seqlens) for k in keys},
            trailing_shapes={
                k: (tuple(v.shape[1:]) if v is not None else None)
                for k, v in data.items()
            },
            dtypes={
                k: (v.dtype if v is not None else None) for k, v in data.items()
            },
            data=data,
            metadata=metadata,
        )

    @property
    def bs(self) -> int:
        return len(self.ids)

    def total_seqlen(self, key: str) -> int:
        return sum(sum(l) for l in self.seqlens[key])

    def _get_split_key(self) -> str:
        return max(self.keys, key=lambda k: self.total_seqlen(k))

    @classmethod
    def gather(
        cls,
        samples: List["SequenceSample"],
        keys: Optional[Sequence[str]] = None,
    ) -> "SequenceSample":
        keys = set(keys) if keys is not None else set(samples[0].keys)
        seqlens = {k: sum((s.seqlens[k] for s in samples), []) for k in keys}
        if samples[0].data is not None:
            data = {
                k: (
                    np.concatenate([s.data[k] for s in samples], axis=0)
                    if samples[0].data[k] is not None
                    else None
                )
                for k in keys
            }
        else:
            data = None
        metadata = {
            k: sum((s.metadata[k] for s in samples), [])
            for k in samples[0].metadata
        }
        return cls(
            keys=keys,
            dtypes={k: samples[0].dtypes[k] for k in keys},
            trailing_shapes={k: samples[0].trailing_shapes[k] for k in keys},
            ids=sum((s.ids for s in samples), []),
            seqlens=seqlens,
            data=data,
            metadata=metadata,
        )

    def split_with_spec(self, spec: SequenceSplitSpec) -> List["SequenceSample"]:
        out = []
        data_offset = {k: 0 for k in self.keys}
        for start, end in spec.partitions:
            new_seqlens = {k: v[start:end] for k, v in self.seqlens.items()}
            chunk_len = {
                k: sum(sum(l) for l in v) for k, v in new_seqlens.items()
            }
            if self.data is not None:
                new_data = {
                    k: (
                        v[data_offset[k] : data_offset[k] + chunk_len[k]]
                        if v is not None
                        else None
                    )
                    for k, v in self.data.items()
                }
            else:
                new_data = None
            for k in self.keys:
                data_offset[k] += chunk_len[k]
            out.append(
                SequenceSample(
                    keys=self.keys,
                    dtypes=self.dtypes,
                    trailing_shapes=self.trailing_shapes,
                    ids=self.ids[start:end],
                    seqlens=new_seqlens,
                    data=new_data,
                    metadata={
                        k: v[start:end] for k, v in self.metadata.items()
                    },
                )
            )
        return out

    def split_with_lengths(
        self, mb_spec: MicroBatchSpec, lens: List[int]
    ) -> Tuple[List["SequenceSample"], np.ndarray, np.ndarray]:
        """Micro-batches bounded by ``max_tokens_per_mb``, at least
        ``n_mbs`` of them.  Returns (micro_batches, forward_indices,
        backward_indices); :meth:`reorder_output` restores the original
        order of per-token outputs."""
        groups = datapack.ffd_allocate(
            lens, mb_spec.max_tokens_per_mb, min_groups=mb_spec.n_mbs
        )
        groups = sorted(sorted(g) for g in groups)
        forward_indices = np.array(datapack.flat2d(groups), dtype=np.int64)
        sample = SequenceSample.reorder(self, forward_indices)
        backward_indices = np.zeros(self.bs, dtype=np.int64)
        backward_indices[forward_indices] = np.arange(self.bs)
        spec = SequenceSplitSpec(sizes=[len(g) for g in groups])
        return sample.split_with_spec(spec), forward_indices, backward_indices

    def split(
        self, mb_spec: MicroBatchSpec
    ) -> Tuple[List["SequenceSample"], np.ndarray, np.ndarray]:
        lens = [sum(l) for l in self.seqlens[self._get_split_key()]]
        return self.split_with_lengths(mb_spec, lens)

    @staticmethod
    def reorder(
        sample: "SequenceSample", indices: Sequence[int]
    ) -> "SequenceSample":
        assert set(int(i) for i in indices) == set(range(sample.bs))
        pieces = sample.unpack()
        return SequenceSample.gather([pieces[int(i)] for i in indices])

    @staticmethod
    def reorder_output(
        x: np.ndarray,
        expected_seqlens: List[List[int]],
        forward_indices: Sequence[int],
        backward_indices: Sequence[int],
    ) -> np.ndarray:
        """Restore original batch order for a packed per-token output ``x``
        produced from the reordered (micro-batched) sample."""
        actual = [expected_seqlens[int(i)] for i in forward_indices]
        group_lens = [sum(s) for s in actual]
        assert x.shape[0] == sum(group_lens)
        offsets = np.concatenate([[0], np.cumsum(group_lens)])
        chunks = [
            x[offsets[i] : offsets[i + 1]] for i in range(len(group_lens))
        ]
        return np.concatenate(
            [chunks[int(i)] for i in backward_indices], axis=0
        )

    def unpack(self) -> List["SequenceSample"]:
        return self.split_with_spec(
            SequenceSplitSpec(partitions=[(i, i + 1) for i in range(self.bs)])
        )

    def update_(self, other: "SequenceSample"):
        """Merge ``other``'s keys into self (ids must match)."""
        assert self.ids == other.ids, (self.ids, other.ids)
        self.keys = self.keys | other.keys
        self.trailing_shapes.update(other.trailing_shapes)
        self.dtypes.update(other.dtypes)
        self.seqlens.update(other.seqlens)
        if self.data is not None and other.data is not None:
            self.data.update(other.data)
        self.metadata.update(other.metadata)

    def __repr__(self):
        return (
            f"SequenceSample(bs={self.bs}, keys={sorted(self.keys)}, "
            f"has_data={self.data is not None})"
        )
