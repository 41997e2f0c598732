"""Worker configuration (the ``GenServerConfig`` part of
``areal_tpu/api/system_api.py``).

The JAX package's config carries a ``MeshSpec`` (``base/topology.py``,
which imports JAX).  The port serves on one device, so ``mesh_spec`` here
is ``None`` or any object with a ``world_size`` attribute, and
:meth:`GenServerConfig.world_size` must be 1 (checked by the server).
Fields keep the reference's names and defaults; those whose feature is not
ported are refused by the server when set away from their default (see
:class:`areal_tpu_torch.system.generation_server.GenerationServerWorker`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from areal_tpu_torch.api.config import ModelAbstraction
from areal_tpu_torch.observability.tracing import TraceConfig


@dataclasses.dataclass
class GenServerConfig:
    worker_name: str
    model: ModelAbstraction = None
    # None = one device; a mesh spec of world size > 1 is refused
    mesh_spec: Optional[Any] = None
    tokenizer_path: Optional[str] = None
    max_concurrent_batch: int = 64
    kv_cache_len: int = 32768
    # tokens generated device-side between host syncs
    chunk_size: int = 64
    temperature: float = 1.0
    # greedy (argmax) decoding server-wide
    greedy: bool = False
    # KV layout: "auto" uses the paged block pool at kv_cache_len >= 2k
    # (the dense per-row cache below it is not ported); kv_pool_tokens
    # sizes the pool (None = max_batch * kv_cache_len); prefill_chunk_tokens
    # bounds the per-step admission prefill (chunked prefill)
    cache_mode: str = "auto"
    page_size: int = 1024
    kv_pool_tokens: Optional[int] = None
    # "auto" (model-dtype pool) or "int8" (int8 pool, f32 scales)
    kv_cache_dtype: str = "auto"
    # "auto" only: int8 serving weights are not ported yet
    serving_weight_dtype: str = "auto"
    prefill_chunk_tokens: int = 1024
    # the radix prefix cache over the paged pool
    prefix_cache: bool = True
    prefix_cache_capacity_frac: float = 0.5
    prefix_cache_min_match_tokens: int = 64
    # 0 only: the host spill tier is not ported yet
    prefix_cache_host_bytes: int = 0
    # "unified" only: prefill/decode roles are not ported yet
    role: str = "unified"
    handoff_request_timeout: float = 60.0
    # read only by prefill/decode roles
    handoff_streaming: bool = True
    # "host-numpy" only: the KV fabric is not ported yet
    segment_transport: str = "host-numpy"
    prefix_pull_min_tokens: int = 256
    # None or a block with ``enabled=False``: speculative decoding is not
    # ported yet
    spec_decode: Optional[Any] = None
    # the request-level SLO plane (observability/latency.py)
    slo_tracking: bool = True
    # decode-pipeline depth: chunks dispatched but not yet harvested
    pipeline_depth: int = 2
    # dispatch-table overrides (None = engine/dispatch.py defaults)
    paged_min_cache_len: Optional[int] = None
    deep_kernel_min_context: Optional[int] = None
    # 0 only: the compile watch is not ported yet
    compile_quiet_after_steps: int = 0
    # staged weight sync: the snapshot restores through at most this many
    # bytes of host buffers straight onto the engine's device; None =
    # one-shot restore
    stage_chunk_bytes: Optional[int] = 256 * 1024 * 1024
    # which local CUDA device hosts the engine (None = the current one)
    device_idx: Optional[int] = None
    # the engine's device: None = ``cuda`` (``cuda:<device_idx>``), or
    # "cpu" when the caller asks for the CPU
    device: Optional[str] = None
    # multi-process serving is not ported yet: num_processes must be 1
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0
    trace: Optional[TraceConfig] = None

    @property
    def world_size(self) -> int:
        """Devices of this server's mesh (1 without a mesh spec)."""
        return int(getattr(self.mesh_spec, "world_size", 1))
