"""Training and inference engine for one model on one device (port of
``areal_tpu/engine/train_engine.py``'s ``TrainEngine`` without meshes).

* Parameters are float32 master weights (a dict tree of tensors with
  ``requires_grad``), as the reference keeps them; the forwards cast each
  matrix to the bf16 activation dtype at use.  bf16 master weights are
  refused: an Adam step of lr below ~1e-4 rounds away on weights of
  magnitude ~0.02 (bf16's spacing there is ~1.2e-4), so such a model
  would not train.
* :meth:`TrainEngine.train_batch` splits a ``SequenceSample`` into
  token-budget micro-batches, lays each out at a common ``[B, T]``
  (segment packing by default), accumulates gradients over them, divides
  by the global loss denominator, clips and updates: the same numbers as
  one big batch.  The reference also appends all-zero micro-batches to
  round their count up to a power of two, which only bounds its number of
  compiled programs; they add zero loss, zero denominator and zero
  gradient, and are skipped here.  Statistics stay on the device until one
  transfer at the end of the step.
* Loss functions are ``(params, cfg, batch) -> (loss_sum, denom, stats)``
  over a batch dict of device tensors, as in the reference.

The engine updates its parameters in place (it takes ownership of the
tensors it is given).  Checkpoints (``save_train_state``,
``load_train_state``) and ``save_hf`` are not ported.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.base import datapack
from areal_tpu_torch.base.device import DeviceLike, resolve_device
from areal_tpu_torch.engine import batching
from areal_tpu_torch.engine.optimizer import OptimizerConfig, make_optimizer
from areal_tpu_torch.models.config import TransformerConfig

# loss_fn(params, cfg, batch) -> (loss_sum, denom, stats)
LossFn = Callable[
    [Any, TransformerConfig, Dict[str, torch.Tensor]],
    Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]],
]
# fwd_fn(params, cfg, batch) -> [B, T]-aligned output tensor
FwdFn = Callable[[Any, TransformerConfig, Dict[str, torch.Tensor]], torch.Tensor]

#: dense bf16 tensor-core peaks (NVIDIA data sheets, SXM parts) by card name
_PEAK_BF16_FLOPS = {"H100": 989e12, "H200": 989e12}


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def device_peak_flops(device: torch.device) -> float:
    """The card's dense bf16 peak, or 0 where it is not known (then no MFU
    is reported)."""
    if device.type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device)
    return next((f for k, f in _PEAK_BF16_FLOPS.items() if k in name), 0.0)


class TrainEngine:
    """One model on one device: float32 parameters and optional AdamW."""

    def __init__(
        self,
        model_cfg: TransformerConfig,
        mesh,
        params,
        optimizer_cfg: Optional[OptimizerConfig] = None,
        total_train_steps: int = 1,
        pack_sequences: bool = True,
        device: DeviceLike = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "meshes (data/fsdp/model/seq/pipe parallelism) are not "
                "ported; TrainEngine runs on one device (mesh=None)"
            )
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.optimizer_cfg = optimizer_cfg
        self.pack_sequences = pack_sequences
        bad = [
            tuple(t.shape) for t in tree_leaves(params)
            if t.dtype != torch.float32
        ]
        if bad:
            raise ValueError(
                f"TrainEngine keeps float32 master parameters; got "
                f"{len(bad)} leaves of another dtype (first shape {bad[0]}). "
                "Use init_params(..., dtype=torch.float32) or "
                "params_from_jax"
            )
        self.params = tree_map(
            lambda t: t.detach().to(self.device).requires_grad_(True), params
        )
        self._leaves = tree_leaves(self.params)
        self.opt = None
        if optimizer_cfg is not None:
            self.opt = make_optimizer(optimizer_cfg, total_train_steps)
            self.opt.init(self._leaves)
        self.version = 0
        self._peak_flops = device_peak_flops(self.device)

    #: last step's throughput, MFU and padding waste
    last_tokens_per_sec: float = 0.0
    last_mfu: float = 0.0
    last_padding_frac: float = 0.0
    #: micro-batches the last forward_batch dispatched
    last_forward_mbs: int = 0

    # -- helpers ------------------------------------------------------------

    def _device_batch(self, pb: batching.PaddedBatch) -> Dict[str, torch.Tensor]:
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in batching.batch_dict(pb).items()
        }

    def _pad(self, sample: SequenceSample, token_key: str) -> batching.PaddedBatch:
        if self.pack_sequences:
            return batching.pack_batch(sample, token_key=token_key)
        return batching.pad_batch(sample, token_key=token_key)

    def _layout(self, mbs, token_key: str) -> List[batching.PaddedBatch]:
        """Every micro-batch at a common [B, T], as the reference stacks
        them (packing: rows of ``bucket_len(longest)``)."""
        seqlens = [
            [l for ls in mb.seqlens[token_key] for l in ls] for mb in mbs
        ]
        if self.pack_sequences:
            T = batching.bucket_len(max(max(s) for s in seqlens))
            all_bins = [datapack.bin_pack_ffd(s, T) for s in seqlens]
            rows = max(len(b) for b in all_bins)
            seg_cap = batching.next_pow2(max(len(s) for s in seqlens))
            return [
                batching.pack_batch(
                    mb, token_key=token_key, fixed_rows=rows, fixed_len=T,
                    fixed_segs=seg_cap, bins=b,
                )
                for mb, b in zip(mbs, all_bins)
            ]
        rows = max(len(s) for s in seqlens)
        T = batching.bucket_len(max(max(s) for s in seqlens))
        return [
            batching.pad_batch(mb, token_key=token_key, fixed_rows=rows, fixed_len=T)
            for mb in mbs
        ]

    # -- training -----------------------------------------------------------

    def train_batch(
        self,
        sample: SequenceSample,
        loss_fn: LossFn,
        mb_spec: MicroBatchSpec,
        token_key: str = "packed_input_ids",
    ) -> Dict[str, float]:
        """Micro-batched, grad-accumulated train step over ``sample``."""
        if self.opt is None:
            raise RuntimeError("engine built without an optimizer")
        tik = time.perf_counter()
        mbs, *_ = sample.split(mb_spec)
        pbs = self._layout(mbs, token_key)
        # every host-to-device copy before any compute is queued: a copy from
        # pageable memory waits for the stream, and would stall the host
        # behind the previous micro-batch's backward
        batches = [self._device_batch(pb) for pb in pbs]
        slots = len(pbs) * pbs[0].padded_slots
        real_tokens = sum(
            int(l) for per_id in sample.seqlens[token_key] for l in per_id
        )
        self.last_padding_frac = 1.0 - real_tokens / max(slots, 1)

        loss_acc = denom_acc = None
        stats_acc: Dict[str, torch.Tensor] = {}
        for batch in batches:
            loss_sum, denom, stats = loss_fn(self.params, self.model_cfg, batch)
            loss_sum.backward()
            loss_sum, denom = loss_sum.detach().float(), denom.detach().float()
            loss_acc = loss_sum if loss_acc is None else loss_acc + loss_sum
            denom_acc = denom if denom_acc is None else denom_acc + denom
            for k, v in stats.items():
                v = v.detach().float()
                stats_acc[k] = stats_acc[k] + v if k in stats_acc else v
        grads = [
            p.grad if p.grad is not None else torch.zeros_like(p)
            for p in self._leaves
        ]
        d = torch.clamp(denom_acc, min=1e-8)
        for g in grads:
            g.div_(d)
        gnorm = self.opt.step(self._leaves, grads)
        for p in self._leaves:
            p.grad = None
        self.version += 1
        keys = list(stats_acc)
        host = (
            torch.stack([loss_acc, denom_acc, gnorm, *(stats_acc[k] for k in keys)])
            .cpu()
            .tolist()
        )  # ONE host sync per train step
        elapsed = time.perf_counter() - tik
        loss_f, denom_f, gnorm_f = host[:3]
        self._record_step_metrics(sample, token_key, elapsed, denom_f)
        out = dict(zip(keys, host[3:]))
        out.update(
            loss=loss_f / max(denom_f, 1e-8),
            grad_norm=gnorm_f,
            n_tokens=denom_f,
            n_mbs=len(mbs),
            tokens_per_sec=self.last_tokens_per_sec,
        )
        if self.last_mfu > 0:
            out["mfu"] = self.last_mfu
        return out

    def _record_step_metrics(self, sample, token_key, elapsed, n_tokens):
        """Step time, token throughput and, on a card with a known peak,
        MFU (``train_flops`` over step time over the peak)."""
        from areal_tpu_torch.system import flops_counter

        self.last_tokens_per_sec = n_tokens / max(elapsed, 1e-9)
        self.last_mfu = 0.0
        if self._peak_flops > 0:
            lens = [int(l) for per_id in sample.seqlens[token_key] for l in per_id]
            fl = flops_counter.train_flops(self.model_cfg, lens)
            self.last_mfu = fl / max(elapsed, 1e-9) / self._peak_flops

    # -- inference ----------------------------------------------------------

    def forward_batch(
        self,
        sample: SequenceSample,
        fwd_fn: FwdFn,
        mb_spec: MicroBatchSpec,
        token_key: str = "packed_input_ids",
        output_shift: int = 0,
    ) -> np.ndarray:
        """Run ``fwd_fn`` over micro-batches; returns the packed 1-D concat
        of per-token outputs in the original sequence order
        (``output_shift=1`` for transition-aligned outputs)."""
        mbs, fwd_idx, bwd_idx = sample.split(mb_spec)
        pbs = [self._pad(mb, token_key) for mb in mbs]
        batches = [self._device_batch(pb) for pb in pbs]
        with torch.no_grad():
            outs = [fwd_fn(self.params, self.model_cfg, b) for b in batches]
        self.last_forward_mbs = len(mbs)
        packed = np.concatenate(
            [
                batching.unpack_per_token(o.float().cpu().numpy(), pb, shift=output_shift)
                for o, pb in zip(outs, pbs)
            ],
            axis=0,
        )
        expected = [
            [l - output_shift for l in ls] for ls in sample.seqlens[token_key]
        ]
        return SequenceSample.reorder_output(packed, expected, fwd_idx, bwd_idx)

    # -- weights ------------------------------------------------------------

    def get_host_params(self):
        """A numpy copy of the parameters (the port's layout: a list of
        per-layer dicts)."""
        return tree_map(lambda t: t.detach().cpu().numpy().copy(), self.params)

    @torch.no_grad()
    def set_params(self, params):
        """Copy ``params`` (same tree) into the engine's parameters."""
        for dst, src in zip(self._leaves, tree_leaves(params)):
            dst.copy_(torch.as_tensor(src).to(dst.device, dst.dtype))

    def save_hf(self, *args, **kwargs):
        raise NotImplementedError("save_hf (HF export) is not ported")

    def save_train_state(self, path: str):
        raise NotImplementedError("train-state checkpoints are not ported")

    def load_train_state(self, path: str) -> bool:
        raise NotImplementedError("train-state checkpoints are not ported")
