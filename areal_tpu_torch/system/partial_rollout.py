"""Chunked (interruptible) generation client (copy of
``areal_tpu/system/partial_rollout.py``; reference:
realhf/system/partial_rollout.py :29 — splits each group member's
generation into ``new_tokens_per_chunk`` chunks; when a chunk ends without
EOS the continuation is re-scheduled (the server may have new weights by
then), accumulating logprobs and tracking version_start/version_end;
groups are reassembled before replying).

One addition: the port's server reports the weight version of every
output token, and the merged output carries them across chunks
(``APIGenerateOutput.output_versions``).
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, List, Optional, Tuple

from areal_tpu_torch.api import model_api
from areal_tpu_torch.base import logging_
from areal_tpu_torch.observability.tracing import get_tracer
from areal_tpu_torch.system.generation_server import GenServerClient

logger = logging_.getLogger("partial_rollout")


class PartialRolloutManager:
    #: RPC failure classes worth retrying: scheduling/generation timeouts
    #: and connection drops are transient (a server draining a long chunk,
    #: a manager busy with a weight swap); server-side errors
    #: (RuntimeError from an error response) are not — they reproduce.
    TRANSIENT_ERRORS = (TimeoutError, ConnectionError, OSError)

    def __init__(
        self,
        manager_client,  # GserverManagerClient
        gconfig: model_api.GenerationHyperparameters,
        new_tokens_per_chunk: int = 1 << 30,
        request_timeout: float = 600.0,
        max_rpc_retries: int = 3,
        rpc_retry_backoff_s: float = 0.5,
        workload: str = "rollout",
        batch_schedule: bool = True,
    ):
        self.manager_client = manager_client
        self.gconfig = gconfig
        # schedule all group siblings' first chunks in ONE manager RPC
        # (schedule_batch); flips off permanently on the first manager
        # that answers "unknown command" (wire compat with old managers)
        self.batch_schedule = bool(batch_schedule)
        self._batch_ok = True
        # SLO/tenant label every chunk of this manager's traffic carries
        # (RolloutWorkerConfig.workload): it segments the fleet-merged
        # latency percentiles AND marks the rows as bulk-priority so the
        # engine's pool-pressure preemption evicts them before
        # interactive gateway rows.
        self.workload = str(workload or "rollout")
        self.new_tokens_per_chunk = max(1, new_tokens_per_chunk)
        self.request_timeout = request_timeout
        self.max_rpc_retries = max(1, max_rpc_retries)
        self.rpc_retry_backoff_s = max(0.0, rpc_retry_backoff_s)
        self._server_clients: Dict[str, GenServerClient] = {}
        self._tracer = get_tracer()

    def _client(self, addr: str) -> GenServerClient:
        if addr not in self._server_clients:
            self._server_clients[addr] = GenServerClient(
                addr, timeout=self.request_timeout
            )
        return self._server_clients[addr]

    async def _gen_chunk(
        self, qid: str, tag: int, prompt_ids: List[int], cur: List[int],
        chunk: int, root: Optional[str] = None,
        presched: Optional[Dict] = None,
    ) -> Tuple[model_api.APIGenerateOutput, int]:
        """Schedule + generate ONE chunk, retrying transient RPC failures
        with capped exponential backoff.  A timed-out schedule or a
        connection reset used to propagate the first exception straight
        into the rollout worker's harvest loop, cancelling the whole
        trajectory for a blip; the retry re-SCHEDULES each attempt (the
        manager may route the continuation elsewhere by then).  Non-
        transient failures still raise after the attempts are spent.

        A timed-out *generate* may have left a live orphan row on the
        server under the attempt's request id — the engine keeps decoding
        it, and a later submission of the SAME id would collide with it
        (clobbered result slot; the orphan's stale output could answer
        the new request).  So each timeout permanently retires the
        current id: the retry — and every later chunk of this sequence —
        generates under ``{qid}#r{tag}`` (``tag`` monotone per
        ``_gen_one``), while SCHEDULING stays keyed on the plain ``qid``
        (server stickiness, group affinity, and the manager's token
        accounting are per-conversation, not per-attempt).  Park-resume
        keys on the generate id and keeps working across chunks; after a
        retry switches ids once, the radix prefix cache serves the old
        id's prefix.  Returns ``(output, tag)`` so the caller carries the
        retired-id state forward."""
        last_exc: Optional[BaseException] = None
        for attempt in range(self.max_rpc_retries):
            if attempt:
                await asyncio.sleep(
                    min(self.rpc_retry_backoff_s * 2 ** (attempt - 1), 10.0)
                )
            gen_qid = qid if tag == 0 else f"{qid}#r{tag}"
            self._tracer.span_begin(
                qid, "rollout.chunk", root=root,
                attempt=attempt, gen_qid=gen_qid,
            )
            t_sched = time.monotonic()
            if attempt == 0 and presched is not None:
                # this member's first chunk was already placed by the
                # group's one schedule_batch RPC; retries (and every
                # later chunk) re-schedule per-qid as before
                sched = presched["sched"]
                sched_wait = presched["wait_s"]
            else:
                try:
                    sched = await asyncio.to_thread(
                        self.manager_client.call,
                        "schedule_request",
                        {
                            "qid": qid,
                            # load signal for cache-aware / token-usage
                            # routing
                            "prompt_len": len(cur),
                            "new_token_budget": chunk,
                        },
                    )
                except self.TRANSIENT_ERRORS as e:
                    # scheduling never reached a generation server: no
                    # orphan row can exist, so the id is NOT retired
                    # (retiring it here would abandon a parked row the
                    # next chunk could have resumed prefill-free)
                    last_exc = e
                    self._trace_retry(qid, root, "schedule", attempt, e)
                    logger.warning(
                        "transient RPC failure scheduling %s "
                        "(attempt %d/%d): %r",
                        qid, attempt + 1, self.max_rpc_retries, e,
                    )
                    continue
                sched_wait = time.monotonic() - t_sched
            try:
                client = self._client(sched["url"])
                metadata = {
                    # SLO plane: client-observed routing latency, stamped
                    # on THIS clock (no cross-host skew) — the engine
                    # folds it into the request's LatencyRecord
                    "slo_schedule_wait_s": sched_wait,
                    # tenant/workload label (per-workload SLO rows) +
                    # bulk priority class: rollout rows yield to
                    # interactive gateway rows under pool pressure
                    "workload": self.workload,
                    "priority_class": "bulk",
                }
                if sched.get("handoff_to"):
                    # two-stage P/D routing: this chunk runs on a
                    # prefill server which streams the KV to the named
                    # decode server segment by segment; the next
                    # chunk's schedule sticky-routes there and resumes
                    # prefill-free
                    metadata["handoff_to"] = sched["handoff_to"]
                elif sched.get("pd_shed"):
                    # saturated prefill pool: the manager shed this
                    # request to its decode owner, which serves it
                    # unified-style (prefill + decode in one place) —
                    # carried in metadata so latency attribution can
                    # separate shed TTFT from two-stage TTFT
                    metadata["pd_shed"] = True
                if sched.get("kv_source"):
                    # fleet KV fabric: the manager's prefix directory
                    # says a peer owns a longer cached prefix for this
                    # session than the routed server holds — the engine
                    # peer-pulls it instead of re-prefilling, falling
                    # back to a plain re-prefill on any reject
                    metadata["kv_source"] = sched["kv_source"]
                inp = model_api.APIGenerateInput(
                    qid=gen_qid,
                    prompt_ids=prompt_ids,
                    input_ids=cur,
                    gconfig=self.gconfig.new(max_new_tokens=chunk, n=1),
                    metadata=metadata,
                )
                out = await asyncio.to_thread(client.generate, inp)
                self._tracer.span_end(
                    qid, "rollout.chunk", root=root, server=sched["url"],
                )
                return out, tag
            except self.TRANSIENT_ERRORS as e:
                last_exc = e
                tag += 1  # gen_qid may have a live orphan row: retire it
                self._trace_retry(qid, root, "generate", attempt, e)
                logger.warning(
                    "transient RPC failure generating %s (attempt %d/%d): "
                    "%r",
                    gen_qid, attempt + 1, self.max_rpc_retries, e,
                )
        assert last_exc is not None
        raise last_exc

    def _trace_retry(self, qid, root, stage, attempt, exc):
        """A retry is exactly the lifetime worth attributing: force the
        whole trace root into the sample set, close the failed chunk
        span, and record the retry event."""
        r = root if root is not None else qid
        self._tracer.force(r)
        self._tracer.span_end(
            qid, "rollout.chunk", root=root, failed=stage,
        )
        self._tracer.event(
            qid, "rollout.retry", root=root,
            stage=stage, attempt=attempt, error=repr(exc),
        )

    async def _gen_one(
        self,
        qid: str,
        prompt_ids: List[int],
        root: Optional[str] = None,
        presched: Optional[Dict] = None,
    ) -> model_api.APIGenerateOutput:
        remaining = self.gconfig.max_new_tokens
        cur = list(prompt_ids)
        out_ids: List[int] = []
        out_lps: List[float] = []
        out_versions: List[int] = []
        version_start: Optional[int] = None
        version_end = -1
        no_eos = True
        tag = 0  # bumps past ids retired by generate timeouts (see _gen_chunk)
        n_chunks = 0
        self._tracer.span_begin(qid, "rollout.generate", root=root)
        while remaining > 0:
            chunk = min(self.new_tokens_per_chunk, remaining)
            out, tag = await self._gen_chunk(
                qid, tag, prompt_ids, cur, chunk, root=root,
                presched=presched,
            )
            presched = None  # only the first chunk was batch-placed
            n_chunks += 1
            if version_start is None:
                version_start = out.version_start
            version_end = out.version_end
            out_ids.extend(out.output_ids)
            out_lps.extend(out.output_logprobs)
            out_versions.extend(out.output_versions)
            cur = cur + list(out.output_ids)
            remaining -= len(out.output_ids)
            no_eos = out.no_eos
            if not out.no_eos or not out.output_ids:
                break
        self._tracer.span_end(
            qid, "rollout.generate", root=root,
            chunks=n_chunks, retries=tag, n_tokens=len(out_ids),
            version_start=version_start if version_start is not None else -1,
            version_end=version_end,
        )
        return model_api.APIGenerateOutput(
            qid=qid,
            prompt_ids=list(prompt_ids),
            input_ids=list(prompt_ids),
            output_ids=out_ids,
            output_logprobs=out_lps,
            no_eos=no_eos,
            version_start=version_start if version_start is not None else -1,
            version_end=version_end,
            output_versions=out_versions,
        )

    async def _schedule_siblings(
        self, member_qids: List[str], prompt_len: int, chunk: int
    ) -> Optional[List[Dict]]:
        """Place every group member's FIRST chunk with one
        ``schedule_batch`` RPC (affinity co-locates siblings anyway, so
        batching costs nothing and saves group_size-1 round trips).
        Returns per-member ``{"sched", "wait_s"}`` records, or None to
        fall back to per-member scheduling — an old manager that does
        not know the command flips batching off permanently; a
        transient failure just skips it this once (each member's own
        retry machinery handles its first chunk)."""
        if not (
            self.batch_schedule
            and self._batch_ok
            and len(member_qids) > 1
            and chunk > 0
        ):
            return None
        t0 = time.monotonic()
        try:
            resp = await asyncio.to_thread(
                self.manager_client.call,
                "schedule_batch",
                {
                    "qids": list(member_qids),
                    "prompt_len": prompt_len,
                    "new_token_budget": chunk,
                },
            )
            scheds = resp["responses"]
        except RuntimeError as e:
            self._batch_ok = False
            logger.warning(
                "manager rejected schedule_batch (%r); falling back to "
                "per-member scheduling for good", e,
            )
            return None
        except self.TRANSIENT_ERRORS as e:
            logger.warning(
                "transient RPC failure batch-scheduling %d siblings "
                "(%r); members schedule individually",
                len(member_qids), e,
            )
            return None
        if len(scheds) != len(member_qids):
            self._batch_ok = False
            logger.warning(
                "schedule_batch answered %d/%d placements; falling back",
                len(scheds), len(member_qids),
            )
            return None
        wait = time.monotonic() - t0
        return [{"sched": s, "wait_s": wait} for s in scheds]

    async def generate_group(
        self, qid: str, prompt_ids: List[int], group_size: int
    ) -> model_api.BundledGenerationOutputs:
        # qid is rollout-level ("{rollout}" or "{rollout}@t{j}"): the
        # trace root is the rollout qid, shared by every member/attempt
        root = qid.split("@", 1)[0]
        members = [f"{qid}-{i}" for i in range(group_size)]
        presched = await self._schedule_siblings(
            members,
            len(prompt_ids),
            min(self.new_tokens_per_chunk, self.gconfig.max_new_tokens),
        )
        outs = await asyncio.gather(
            *(
                self._gen_one(
                    m, prompt_ids, root=root,
                    presched=presched[i] if presched else None,
                )
                for i, m in enumerate(members)
            )
        )
        outs = list(outs)
        for o in outs:
            o.qid = qid
        return model_api.BundledGenerationOutputs.from_api_outputs(outs)

    def close(self):
        for c in self._server_clients.values():
            c.close()
