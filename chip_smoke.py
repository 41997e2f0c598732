"""Drive the PyTorch port's serving path on one CUDA card and check it.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``areal_tpu_torch/csrc`` (into
``areal_tpu_torch/_build/``), holds the kernel against its plain PyTorch
version at the serving path's shapes, serves requests through
``areal_tpu_torch``'s ``ContinuousBatchingEngine`` at the full width and
depth of the Qwen2.5-1.5B architecture (random weights from a seed), and
checks the outputs.  Every phase raises on failure, so the script exits
non-zero.  It exits non-zero without printing a result when no CUDA card
is present, or when the ``areal_tpu_torch`` package is not beside it.

Output, in order: the card (``nvidia-smi`` name and power limit), the
build, the kernel comparison, the engine's throughput and checks, then
on the last three lines the card again, one ``{"kernels": [...]}`` JSON
line, and the final ``{"ok": true, "device": {...}}`` JSON line.

All float32 matrix products here run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``), so the plain
versions are exact float32 references.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SEED = 0
PAGE_SIZE = 256
MAX_BATCH = 8
KV_CACHE_LEN = 4096
PREFILL_CHUNK = 512
CHUNK_SIZE = 16
PIPELINE_DEPTH = 2
NEW_TOKENS = 128
#: prompt lengths of the 8 requests: spread over 300-3000 tokens, crossing
#: page (256) and prefill-chunk (512) boundaries
PROMPT_LENS = (300, 3000, 777, 1536, 513, 2049, 1023, 2600)

#: GPU clock cycles the timing loop holds the stream for (~0.1 s at the
#: H100's ~1.98 GHz boost clock; the timed calls enqueue in far less)
SLEEP_CYCLES = 200_000_000

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# kernel-vs-plain tolerances: both sides compute in float32 from the
# same bf16 inputs and differ only in summation order
TOL_OUT = 2e-4  # max |acc/l - ref| (outputs are O(1) averages of V rows)
TOL_M = 1e-4  # max |m - ref| (scores are O(1) after the 1/sqrt(hd) scale)
TOL_L_REL = 1e-4  # max |l - ref| / max(1, |ref|)
#: relative L2 distance allowed between chunked and one-chunk prefill
#: logits: bf16 activations round at other places when the prefix is read
#: back from the pool through the kernel instead of attended in-chunk
TOL_CHUNKED_LOGITS = 3e-2


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, device) -> float:
    """Mean device milliseconds per call of ``fn`` (warmed up; CUDA
    events).  The stream is first held by a sleep kernel long enough for
    the host to enqueue every call, so the events time the device work
    back to back, without the host's launch gaps between calls."""
    import torch

    fn()
    if device.type != "cuda":
        tik = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - tik) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# kernel vs plain version
# ---------------------------------------------------------------------------


def paged_inputs(B, Q, Hq, Hkv, hd, BS, MB, lengths, device, dtype,
                 n_layers, seed):
    """q [B,Q,Hq,hd], pools [n_layers, NB, Hkv, BS, hd] (NB = B*MB) with a
    scrambled table [B, MB] and the given lengths."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    NB = B * MB
    q = torch.randn((B, Q, Hq, hd), generator=g, device=device).to(dtype)
    kp = torch.randn((n_layers, NB, Hkv, BS, hd), generator=g,
                     device=device).to(dtype)
    vp = torch.randn((n_layers, NB, Hkv, BS, hd), generator=g,
                     device=device).to(dtype)
    perm = torch.randperm(NB, generator=g, device=device)
    tables = perm.reshape(B, MB).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, kp, vp, tables, lens


def bound(q, lengths, Hkv, hd):
    """(bytes ms, operations ms) for one call: bytes that must move (q,
    the valid K/V prefix, tables and lengths read once; acc, m, l written
    once) over HBM rate, vs the attention arithmetic over the bf16
    tensor-core rate."""
    B, Q, Hq, _ = q.shape
    tot = int(lengths.clamp(min=0).sum())
    item = q.element_size()
    nbytes = (
        q.numel() * item
        + tot * Hkv * hd * 2 * item
        + B * 4 * 2
        + B * Q * Hq * (hd + 2) * 4
    )
    flops = 4.0 * tot * Q * Hq * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return t_bytes, t_ops


def compare_kernel(name, B, Q, lengths, device, *, Hq=12, Hkv=2, hd=128,
                   BS=PAGE_SIZE, MB=KV_CACHE_LEN // PAGE_SIZE, n_layers=4,
                   timing_iters=20):
    """Kernel vs plain version on one shape; returns the measurements.
    The pool holds ``n_layers`` layers and timed launches cycle through
    them, so the timed cache traffic does not sit in L2 (at the slice's
    shapes 4 layers of pool exceed the H100's 50 MB L2)."""
    import torch

    from areal_tpu_torch.ops import paged_attention as pa

    q, kp, vp, tables, lens = paged_inputs(
        B, Q, Hq, Hkv, hd, BS, MB, lengths, device, torch.bfloat16,
        n_layers, SEED,
    )
    acc, m, l = pa.paged_flash_attention(q, kp[0], vp[0], tables, lens)
    acc_r, m_r, l_r = pa.reference_paged_partials(
        q, kp[0], vp[0], tables, lens
    )
    if device.type == "cuda":
        torch.cuda.synchronize()
    valid = lens > 0
    out = acc[valid] / l[valid][..., None]
    out_r = acc_r[valid] / l_r[valid][..., None]
    err_out = float((out - out_r).abs().max())
    err_m = float((m[valid] - m_r[valid]).abs().max())
    err_l = float(((l - l_r).abs() / l_r.abs().clamp(min=1.0)).max())
    empty = ~valid
    empty_ok = bool(
        (acc[empty] == 0).all() and (l[empty] == 0).all()
        and (m[empty] == -1e30).all()
    )
    finite = bool(torch.isfinite(acc).all() and torch.isfinite(l).all())
    log(f"kernel {name}: B={B} Q={Q} Hq={Hq} Hkv={Hkv} hd={hd} BS={BS} "
        f"MB={MB} lengths={lengths}: max err acc/l={err_out:.3e} "
        f"m={err_m:.3e} l(rel)={err_l:.3e} empty-rows-exact={empty_ok}")
    if not (finite and empty_ok and err_out <= TOL_OUT and err_m <= TOL_M
            and err_l <= TOL_L_REL):
        raise AssertionError(
            f"paged_flash_attention ({name}) disagrees with its plain "
            f"version: acc/l {err_out} (tol {TOL_OUT}), m {err_m} (tol "
            f"{TOL_M}), l {err_l} (tol {TOL_L_REL}), empty rows exact "
            f"{empty_ok}, finite {finite}"
        )
    layer = [0]

    def kern():
        i = layer[0] = (layer[0] + 1) % n_layers
        pa.paged_flash_attention(q, kp[i], vp[i], tables, lens)

    def plain():
        i = layer[0] = (layer[0] + 1) % n_layers
        pa.reference_paged_partials(q, kp[i], vp[i], tables, lens)

    ms = time_ms(kern, timing_iters, device)
    plain_ms = time_ms(plain, max(2, timing_iters // 10), device)
    t_bytes, t_ops = bound(q, lens, Hkv, hd)
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"kernel {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms by {bound_by} (bytes / 3.35 TB/s: {t_bytes:.5f} "
        f"ms; operations / 989 TFLOP/s: {t_ops:.5f} ms)")
    return dict(max_abs_err=max(err_out, err_m), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def kernel_phase(device, *, BS=PAGE_SIZE, MB=KV_CACHE_LEN // PAGE_SIZE,
                 Q_prefill=PREFILL_CHUNK, timing_iters=20, **shape):
    """Decode (Q=1, B=8) and prefill-chunk (Q=prefill chunk) shapes, with
    lengths 0, 1, BS-1, BS, BS+1, a full table and two in between."""
    lengths = [0, 1, BS - 1, BS, BS + 1, MB * BS, (MB * BS) // 3,
               (MB * BS * 3) // 4]
    dec = compare_kernel("decode", len(lengths), 1, lengths, device, BS=BS,
                         MB=MB, timing_iters=timing_iters, **shape)
    pre = compare_kernel("prefill", len(lengths), Q_prefill, lengths,
                         device, BS=BS, MB=MB, timing_iters=timing_iters,
                         **shape)
    return dec, pre


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def make_prompts(vocab: int, lens, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def requests(prompts, max_new, tag):
    from areal_tpu_torch.api.model_api import (
        APIGenerateInput,
        GenerationHyperparameters,
    )

    return [
        APIGenerateInput(
            qid=f"{tag}-{i}", prompt_ids=p, input_ids=p,
            gconfig=GenerationHyperparameters(max_new_tokens=max_new),
        )
        for i, p in enumerate(prompts)
    ]


def serve(eng, reqs, max_steps=100000):
    """Submit ``reqs`` and step the engine until it drains; returns (results
    in request order, wall seconds)."""
    import torch

    tik = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        if not eng.has_work:
            break
        eng.step()
    else:
        raise AssertionError("engine did not drain")
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - tik
    res = eng.drain_results()
    out = [res.pop(r.qid) for r in reqs]
    if res:
        raise AssertionError(f"unexpected results {sorted(res)}")
    return out, secs


def check_outputs(outs, cfg, max_new, what):
    for o in outs:
        n = len(o.output_ids)
        if not (1 <= n <= max_new) or len(o.output_logprobs) != n:
            raise AssertionError(f"{what} {o.qid}: {n} tokens / "
                                 f"{len(o.output_logprobs)} logprobs")
        if not all(0 <= t < cfg.vocab_size for t in o.output_ids):
            raise AssertionError(f"{what} {o.qid}: token out of vocabulary")
        if not all(math.isfinite(x) and x <= 0 for x in o.output_logprobs):
            raise AssertionError(f"{what} {o.qid}: bad logprob")


def build_engine(cfg, params, device, sampling, **kw):
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )

    settings = dict(
        max_batch=MAX_BATCH, kv_cache_len=KV_CACHE_LEN,
        chunk_size=CHUNK_SIZE, cache_mode="paged", page_size=PAGE_SIZE,
        prefill_chunk_tokens=PREFILL_CHUNK, pipeline_depth=PIPELINE_DEPTH,
        seed=SEED,
    )
    settings.update(kw)
    return ContinuousBatchingEngine(
        cfg, params, sampling=sampling, device=device, **settings
    )


def engine_phase(cfg, params, device, *, prompt_lens=PROMPT_LENS,
                 new_tokens=NEW_TOKENS, card="", **engine_kw):
    """The main path: a greedy wave of ``new_tokens`` per request, with the
    kernel's launch count set to 0 just before it and read just after."""
    from areal_tpu_torch.engine.sampling import SamplingParams
    from areal_tpu_torch.ops.paged_attention import paged_flash_attention

    eng = build_engine(cfg, params, device, SamplingParams(greedy=True),
                       **engine_kw)
    prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED)
    # warm-up (library handles, allocator), not timed
    serve(eng, requests([p[:64] for p in prompts[:2]], 4, "warm"))
    # prefill throughput: a wave that stops after each request's first token
    p0 = eng.prefill_tokens_total
    _, prefill_secs = serve(eng, requests(prompts, 1, "prefill"))
    prefill_tps = (eng.prefill_tokens_total - p0) / prefill_secs

    # the main path
    f0, d0 = eng.prefill_calls, eng.decode_chunks_total
    t0 = eng.decode_tokens_total
    paged_flash_attention.launches = 0
    outs, secs = serve(eng, requests(prompts, new_tokens, "greedy"))
    launches = paged_flash_attention.launches
    fills, chunks = eng.prefill_calls - f0, eng.decode_chunks_total - d0
    expected = cfg.n_layers * (fills + chunks * eng.chunk_size)
    check_outputs(outs, cfg, new_tokens, "greedy")
    dec_tok = eng.decode_tokens_total - t0
    decode_tps = dec_tok / (secs - prefill_secs)
    log(f"engine greedy wave: {len(outs)} requests, prompts {list(prompt_lens)}, "
        f"{sum(len(o.output_ids) for o in outs)} new tokens in {secs:.2f} s; "
        f"{fills} fill chunks + {chunks} decode chunks of {eng.chunk_size} "
        f"steps x {cfg.n_layers} layers = {expected} kernel launches "
        f"expected, {launches} counted")
    if launches != expected or launches == 0:
        raise AssertionError(
            f"paged_flash_attention launched {launches} times on the main "
            f"path; the engine dispatched work for {expected}"
        )
    log(f"engine throughput on {card}: prefill {prefill_tps:.1f} tok/s (prompt tokens "
        f"of a first-token-only wave / its wall time {prefill_secs:.2f} s); "
        f"decode {decode_tps:.1f} tok/s ({dec_tok} decode-chunk tokens / "
        f"the greedy wave's wall time less the first-token wave's)")

    # resubmitting the same greedy wave gives the identical streams
    again, _ = serve(eng, requests(prompts, new_tokens, "greedy"))
    if [o.output_ids for o in again] != [o.output_ids for o in outs]:
        raise AssertionError("a resubmitted greedy wave changed its tokens")
    log("engine check: resubmitted greedy wave gives identical tokens")

    # update_weights changes the output and stamps the new version
    short = requests([p[:200] for p in prompts[:2]], 16, "swap")
    before, _ = serve(eng, short)
    perturbed = _perturbed(params, SEED + 3)
    eng.update_weights(perturbed, version=1)
    after, _ = serve(eng, short)
    if [o.output_ids for o in after] == [o.output_ids for o in before]:
        raise AssertionError("update_weights did not change the output")
    if any(o.version_start != 1 or o.version_end != 1 for o in after):
        raise AssertionError("update_weights did not stamp version 1")
    eng.update_weights(params, version=2)
    restored, _ = serve(eng, short)
    if [o.output_ids for o in restored] != [o.output_ids for o in before]:
        raise AssertionError("restoring the weights did not restore output")
    log("engine check: update_weights changes the output, stamps the "
        "version, and restoring the weights restores it")
    leaked = eng.close()
    if leaked or eng.free_pool_blocks != eng.n_blocks:
        raise AssertionError(f"leaked pool blocks: {leaked}, free "
                             f"{eng.free_pool_blocks}/{eng.n_blocks}")
    log("engine check: close() reports no leaked blocks")
    return dict(launches=launches, prefill_tps=prefill_tps,
                decode_tps=decode_tps)


def sampled_phase(cfg, params, device, *, prompt_lens=PROMPT_LENS,
                  new_tokens=NEW_TOKENS, **engine_kw):
    """A second wave sampled at temperature 1, twice, at two pipeline
    depths: the position-keyed streams must agree."""
    from areal_tpu_torch.engine.sampling import SamplingParams

    prompts = make_prompts(cfg.vocab_size, prompt_lens, SEED + 1)
    streams = []
    for depth in (PIPELINE_DEPTH, 1):
        kw = dict(engine_kw, pipeline_depth=depth)
        eng = build_engine(cfg, params, device,
                           SamplingParams(temperature=1.0), **kw)
        outs, secs = serve(eng, requests(prompts, new_tokens, "sampled"))
        check_outputs(outs, cfg, new_tokens, "sampled")
        if eng.close():
            raise AssertionError("sampled engine leaked pool blocks")
        streams.append([o.output_ids for o in outs])
        log(f"engine sampled wave (temperature 1, pipeline depth {depth}): "
            f"{sum(len(s) for s in streams[-1])} tokens in {secs:.2f} s")
    if streams[0] != streams[1]:
        raise AssertionError("sampled streams differ across pipeline depths")
    log("engine check: sampled streams identical across pipeline depths")


def chunked_prefill_phase(cfg, params, device, *, prompt_len=1500,
                          chunk=PREFILL_CHUNK, BS=PAGE_SIZE):
    """The same prompt's final logits with chunked prefill (later chunks
    read the cached pages through the kernel) and one-chunk prefill (which
    reads none)."""
    import torch

    from areal_tpu_torch.models import paged

    prompt = make_prompts(cfg.vocab_size, [prompt_len], SEED + 2)[0]
    MB = -(-prompt_len // BS)
    tables = torch.arange(MB, dtype=torch.int32, device=device)[None]
    i32 = dict(dtype=torch.int32, device=device)

    def prefill(chunk_len):
        kp, vp = paged.alloc_kv_pool(cfg, MB, BS, device)
        for s in range(0, prompt_len, chunk_len):
            n = min(chunk_len, prompt_len - s)
            logits = paged.paged_fill_chunk(
                params, kp, vp, cfg,
                torch.tensor([prompt[s:s + n]], **i32),
                torch.tensor([s], **i32), torch.tensor([n], **i32), tables,
            )
        return logits[0].float()

    a, b = prefill(chunk), prefill(prompt_len)
    rel = float((a - b).norm() / b.norm())
    same_top = bool(a.argmax() == b.argmax())
    log(f"engine check: chunked ({chunk}) vs one-chunk prefill of "
        f"{prompt_len} tokens: relative L2 logit difference {rel:.3e} "
        f"(tolerance {TOL_CHUNKED_LOGITS}), same argmax {same_top}")
    if not (math.isfinite(rel) and rel <= TOL_CHUNKED_LOGITS):
        raise AssertionError("chunked and one-chunk prefill disagree")


def anatomy(fn, label):
    """Host enqueue time, wall time and device busy time of one call of
    ``fn`` (warmed up), and the paged kernel's share of the device time.
    Device time is the sum of the kernels' and copies' own time in a
    ``torch.profiler`` trace of a second call; idle share is one minus
    device time over the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tik = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - tik
    torch.cuda.synchronize()
    wall = time.perf_counter() - tik
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us = kern_us = 0.0
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        busy_us += us
        if "paged_partials_kernel" in ev.key or "combine_splits_kernel" in ev.key:
            kern_us += us
    if busy_us > 0:
        dev = (f"device busy {busy_us / 1e3:.2f} ms (idle share "
               f"{1 - busy_us / 1e6 / wall:.3f}), paged kernel "
               f"{kern_us / 1e3:.2f} ms = {kern_us / busy_us:.3f} of device time")
    else:
        dev = "device time not measured (the profiler saw no device events)"
    log(f"anatomy {label}: host enqueue {enqueue * 1e3:.2f} ms, wall "
        f"{wall * 1e3:.2f} ms; {dev}")
    return wall


def anatomy_phase(cfg, params, device, *, lens=PROMPT_LENS):
    """Where a decode chunk's and a prefill chunk's time goes, outside the
    engine: one decode chunk (8 rows at the prompt lengths, all active,
    ``CHUNK_SIZE`` steps) and one prefill chunk (one row,
    ``PREFILL_CHUNK`` tokens after a 2560-token cached prefix), over a
    pool of random KV."""
    import torch

    from areal_tpu_torch.engine.sampling import (
        SamplingParams,
        sample_logits_keyed,
    )
    from areal_tpu_torch.models import paged

    B, MB = len(lens), KV_CACHE_LEN // PAGE_SIZE
    kp, vp = paged.alloc_kv_pool(cfg, B * MB, PAGE_SIZE, device)
    kp.normal_()
    vp.normal_()
    i32 = dict(dtype=torch.int32, device=device)
    tables = torch.arange(B * MB, **i32).reshape(B, MB)
    lengths = torch.tensor(lens, **i32)
    greedy = SamplingParams(greedy=True)

    def decode():
        paged.paged_decode_chunk(
            params, kp, vp, cfg, tables, lengths, torch.zeros(B, **i32),
            torch.ones(B, dtype=torch.bool, device=device),
            torch.full((B,), 1 << 20, **i32), CHUNK_SIZE,
            lambda lg, pos, sd: sample_logits_keyed(lg, SEED, sd, pos, greedy),
            lambda tok: tok < 0, KV_CACHE_LEN, torch.arange(B, **i32),
        )

    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_CHUNK), **i32)

    def fill():
        paged.paged_fill_chunk(
            params, kp, vp, cfg, toks, torch.tensor([2560], **i32),
            torch.tensor([PREFILL_CHUNK], **i32), tables[:1],
        )

    wall = anatomy(decode, f"decode chunk ({B} rows x {CHUNK_SIZE} steps)")
    log(f"anatomy: decode at batch {B} runs {B * CHUNK_SIZE / wall:.1f} tok/s "
        f"({wall / CHUNK_SIZE * 1e3:.2f} ms per step)")
    wall = anatomy(fill, f"prefill chunk ({PREFILL_CHUNK} tokens)")
    log(f"anatomy: prefill chunk runs {PREFILL_CHUNK / wall:.1f} tok/s")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a card", file=sys.stderr)
        return 2
    try:
        from areal_tpu_torch.models.config import qwen25_15b_config
        from areal_tpu_torch.models.transformer import init_params
        from areal_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the areal_tpu_torch package is not importable "
              f"({e}); run from the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    tik = time.perf_counter()
    lib = _build.load_library("paged_attention")
    log(f"build: {lib.path.name} in {lib.build_seconds:.1f} s of nvcc "
        f"({time.perf_counter() - tik:.1f} s with loading)")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"build: {line.strip()}")

    dec, pre = kernel_phase(device)

    cfg = qwen25_15b_config()
    tik = time.perf_counter()
    params = init_params(cfg, SEED, device)
    torch.cuda.synchronize()
    n_params = sum(
        t.numel() for t in _leaves(params)
    )
    log(f"model: Qwen2.5-1.5B architecture, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters (random, seed {SEED}), built "
        f"in {time.perf_counter() - tik:.1f} s")
    eng = engine_phase(cfg, params, device, card=card)
    sampled_phase(cfg, params, device)
    chunked_prefill_phase(cfg, params, device)
    anatomy_phase(cfg, params, device)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    entry = dict(
        name="paged_flash_attention",
        route="cuda",
        source="areal_tpu_torch/csrc/paged_attention.cu",
        replaces="areal_tpu/ops/paged_attention.py:201",
        launches=eng["launches"],
        max_abs_err=max(dec["max_abs_err"], pre["max_abs_err"]),
        max_err=max(dec["max_abs_err"], pre["max_abs_err"]),
        ms=dec["ms"],
        plain_ms=dec["plain_ms"],
        bound_ms=dec["bound_ms"],
        bound_by=dec["bound_by"],
        library_ms=None,
        shape="decode Q=1 B=8 Hq=12 Hkv=2 hd=128 bf16",
        prefill=dict(shape=f"Q={PREFILL_CHUNK} B=8", ms=pre["ms"],
                     plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
                     bound_by=pre["bound_by"]),
    )
    log(card_line())
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _perturbed(params, seed):
    """``params`` with every layer's MLP output projection moved by noise of
    its own scale (the other leaves are shared, not copied)."""
    import torch

    out = dict(params, layers=[])
    for lp in params["layers"]:
        w = lp["mlp"]["down"]["w"]
        g = torch.Generator(device=w.device)
        g.manual_seed(seed)
        noise = torch.randn(w.shape, generator=g, device=w.device)
        down = dict(lp["mlp"]["down"], w=(w.float() + noise * w.float().std()).to(w.dtype))
        out["layers"].append(dict(lp, mlp=dict(lp["mlp"], down=down)))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
