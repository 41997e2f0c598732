"""The port's int8 serving weights against the JAX package's
(``areal_tpu/models/quantize.py`` and ``serving_weight_dtype="int8"``), on
the CPU: ``quantize_weight`` bit for bit (ties, zero channels, subnormal
and huge values), the tree transform, ``leaf_weight`` and ``_proj``
within 1e-5, an int8 engine's greedy tokens equal to the JAX int8
engine's with logprobs within 1e-4 on the paged, prefix-cache and dense
paths, a quantized swap mid-decode, the serving counters, and the
generation server's format negotiation matrix against the JAX server's.

The JAX package's own divergence pin (int8 against full precision on a
random model, ``tests/engine/test_weight_quant.py``) is not copied: the
port is held against the JAX package's int8 engine instead."""

import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.engine import checkpoint as jck
from areal_tpu.models import quantize as jq
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu.system.generation_server import GenerationServerWorker as JGSW
from areal_tpu_torch.base import logging_
from areal_tpu_torch.engine import checkpoint as tck
from areal_tpu_torch.models import quantize as tq
from areal_tpu_torch.models import transformer as tt
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.system.generation_server import GenerationServerWorker
from areal_tpu.engine.inference_server import (
    ContinuousBatchingEngine as JaxEngine,
)
from areal_tpu.engine.sampling import SamplingParams as JaxSampling
from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.sampling import SamplingParams
from tests.test_torch_engine import (
    ENGINE,
    _assert_same,
    _jax_input,
    _port_input,
    _prompts,
    _run,
)
from tests.test_torch_model import port_config

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_engine(jcfg, tree, **kw):
    return JaxEngine(
        jcfg, jax.tree.map(jnp.asarray, tree),
        sampling=JaxSampling(greedy=True),
        **dict(ENGINE, **dict(dict(prefix_cache=False), **kw)),
    )


def _port_engine(cfg, tree, **kw):
    return ContinuousBatchingEngine(
        cfg, params_from_jax(tree, cfg, "cpu"),
        sampling=SamplingParams(greedy=True), device="cpu",
        **dict(ENGINE, **dict(dict(prefix_cache=False), **kw)),
    )


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=256,
                       use_attention_bias=True, tied_embedding=False)
    trees = [jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(s)))
             for s in (0, 1)]
    return jcfg, port_config(jcfg), trees


def _weights(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 40, 24)) * 0.05).astype(np.float32)
    w[0, :, 0] = 0.0  # an all-zero channel: its scale is the floor
    w[0, :, 1] = 1e-40  # subnormal weights under the floor
    w[0, :, 2] = 3e-39
    w[1, :, 3] = 3.0e37  # huge weights
    # exact half steps: absmax 127 gives scale 1
    w[1, :8, 4] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    w[1, 8:, 4] = 0.25
    w[2, 5, :] = -w[2, 5, :]
    return torch.from_numpy(w).to(dtype), jnp.asarray(w).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_weight_bit_identical(dtype):
    tw, jw = _weights(dtype)
    tqw, tsc = tq.quantize_weight(tw)
    jqw, jsc = jq.quantize_weight(jw)
    assert tqw.dtype == torch.int8 and tsc.dtype == torch.float32
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(tsc.numpy().view(np.int32),
                                  np.asarray(jsc).view(np.int32))
    # ties round half to even; a zero channel dequantizes to exact zeros
    assert tqw[1, :8, 4].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert (tq.dequant_weight(tqw, tsc, torch.float32)[0, :, 0] == 0).all()


def test_tree_transform_and_counters(model):
    jcfg, cfg, trees = model
    tree = params_from_jax(trees[0], cfg, "cpu")
    tqt = tq.quantize_param_tree(tree)
    jqt = jax.device_get(jq.quantize_param_tree(trees[0]))
    assert tq.is_quantized_tree(tqt) and not tq.is_quantized_tree(tree)
    # the port's per-layer list counts each layer's projections
    assert tq.quantized_leaf_count(tqt) == 7 * cfg.n_layers + 1
    assert tq.quantized_leaf_count(
        dict(tqt, layers=tqt["layers"][:1])) == jq.quantized_leaf_count(jqt)
    assert tq.tree_bytes(tqt) == jq.tree_bytes(jqt)
    for l, lp in enumerate(tqt["layers"]):
        for blk, name in (("attn", "q"), ("attn", "o"), ("mlp", "down")):
            got, want = lp[blk][name], jqt["layers"][blk][name]
            np.testing.assert_array_equal(got["qw"].numpy(),
                                          np.asarray(want["qw"][l]))
            np.testing.assert_array_equal(got["scale"].numpy(),
                                          np.asarray(want["scale"][l]))
        # the bias stays beside qw/scale
        assert set(lp["attn"]["q"]) == {"qw", "scale", "b"}
    np.testing.assert_array_equal(tqt["lm_head"]["qw"].numpy(),
                                  np.asarray(jqt["lm_head"]["qw"]))
    # the meta layout has the tree's shapes and dtypes
    struct = tq.quant_tree_struct(tree)
    for (kp, a), (_, b) in zip(tck._flatten(struct), tck._flatten(tqt)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), kp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_weight_and_proj_match_jax(dtype):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((32, 48)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((48,)) * 0.1).astype(np.float32)
    y = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jqw, jsc = jq.quantize_weight(jnp.asarray(w))
    tqw, tsc = tq.quantize_weight(torch.from_numpy(w))
    for jp, tp in (
        (dict(qw=jqw, scale=jsc, b=jnp.asarray(b)),
         dict(qw=tqw, scale=tsc, b=torch.from_numpy(b))),
        (dict(w=jnp.asarray(w)), dict(w=torch.from_numpy(w))),
    ):
        np.testing.assert_allclose(
            tq.leaf_weight(tp, td).float().numpy(),
            np.asarray(jq.leaf_weight(jp, jd).astype(jnp.float32)),
            rtol=1e-5, atol=1e-5)
        got = tt._proj(tp, torch.from_numpy(y).to(td)).float().numpy()
        want = np.asarray(jt._proj(jp, jnp.asarray(y).astype(jd)).astype(
            jnp.float32))
        tol = 1e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("arm", ["paged", "prefix_cache", "dense"])
def test_int8_engine_matches_jax_int8_engine(model, arm):
    """Greedy tokens equal to the JAX int8 engine's, logprobs within 1e-4,
    on the same requests (pages and prefill chunks crossed, EOS and
    budget stops, a prompt too long to serve), then a second wave that
    replays the first's prompts."""
    jcfg, cfg, trees = model
    kw = dict(serving_weight_dtype="int8")
    if arm == "prefix_cache":
        kw["prefix_cache"] = True
    elif arm == "dense":
        kw["cache_mode"] = "dense"
    prompts = _prompts(jcfg.vocab_size)
    jeng = _jax_engine(jcfg, trees[0], **kw)
    teng = _port_engine(cfg, trees[0], **kw)
    for tag in ("a", "b"):
        _assert_same(_run(teng, _port_input, prompts, tag),
                     _run(jeng, _jax_input, prompts, tag))
    assert teng.prefix_cache_stats() == jeng.prefix_cache_stats()
    got, want = teng.weight_quant_stats(), jeng.weight_quant_stats()
    assert got == want
    assert got["quantized"] == 1 and got["storage_bits"] == 8
    assert teng.close() == {}


def test_quantized_swap_mid_decode(model):
    """A full-precision tree swapped into an int8 engine mid-decode is
    quantized (by the engine here, by ``prepare_weights`` on the JAX
    side): the rows in flight recompute and both engines give the same
    tokens under both versions."""
    jcfg, cfg, trees = model
    prompts = _prompts(jcfg.vocab_size, seed=2)
    outs = []
    for make, eng, new in (
        (_jax_input, _jax_engine(jcfg, trees[0], serving_weight_dtype="int8",
                                 prefix_cache=True), None),
        (_port_input, _port_engine(cfg, trees[0], serving_weight_dtype="int8",
                                   prefix_cache=True),
         params_from_jax(trees[1], cfg, "cpu")),
    ):
        if new is None:
            new = eng.prepare_weights(jax.tree.map(jnp.asarray, trees[1]))
        for i, p in enumerate(prompts):
            eng.submit(make(f"s{i}", p, 20))
        for _ in range(5):
            eng.step()
        eng.update_weights(new, version=3)
        for _ in range(600):
            if not eng.has_work:
                break
            eng.step()
        res = eng.drain_results()
        outs.append([res[f"s{i}"] for i in range(len(prompts))])
        assert eng.version == 3
    _assert_same(outs[1], outs[0])
    assert any(o.version_start == 0 and o.version_end == 3 for o in outs[1])


def _Stub(cls, engine, dtype, log):
    """A server's negotiation and restore methods without its sockets:
    ``config``, ``logger`` and ``engine`` are what they read."""
    stub = type("Stub", (), {
        "_negotiate_weight_format": cls._negotiate_weight_format,
        "_load_update_params": cls._load_update_params,
    })()
    stub.engine = engine
    stub.config = types.SimpleNamespace(serving_weight_dtype=dtype,
                                        stage_chunk_bytes=1 << 14)
    stub.logger = log
    stub._negotiate = stub._negotiate_weight_format
    stub._load = stub._load_update_params
    return stub


def _publish(pkg, tree, root, version, with_quant):
    """Publish as a model worker does: the full tree cast to bf16, the int8
    sibling when asked, and a manifest advertising what was written."""
    snap = os.path.join(root, f"v{version}")
    if pkg == "jax":
        jck.save_params(tree, snap)
        sq = None
        if with_quant:
            qpath = jck.quant_snapshot_path(snap)
            sq = {"int8": jck.quant_manifest_entry(
                jck.save_quantized_params(tree, qpath), qpath)}
        jck.write_manifest(jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype), tree),
            snap, version=version, serving_quant=sq)
        return snap
    tck.save_params(tree, snap, cast_dtype=torch.bfloat16)
    sq = None
    if with_quant:
        qpath = tck.quant_snapshot_path(snap)
        sq = {"int8": tck.quant_manifest_entry(tck.save_quantized_params(
            tree, qpath, cast_dtype=torch.bfloat16), qpath)}
    meta = tck._tree_map(lambda t: torch.empty(
        tuple(t.shape), dtype=torch.bfloat16, device="meta"), tree)
    tck.write_manifest(meta, snap, version=version, serving_quant=sq)
    return snap


def test_negotiation_matrix_matches_jax(model, tmp_path):
    """Server format x publisher: an int8 server takes the advertised int8
    tree, and falls back to the full tree (quantized on arrival) when the
    publisher wrote none, the snapshot has no manifest or the advertised
    tree is gone; an ``"auto"`` server takes the full tree.  Each case's
    decision is the JAX server's, and every restore (staged or not) is a
    tree in the engine's resident format, an int8 one equal bit for bit
    to the engine's own quantization of the published weights."""
    jcfg, cfg, trees = model
    log = logging_.getLogger("negotiation")
    tree1 = params_from_jax(trees[1], cfg, "cpu")
    engines = {
        d: _port_engine(cfg, trees[0], serving_weight_dtype=d)
        for d in ("int8", "auto")}
    jengines = {
        d: _jax_engine(jcfg, trees[0], serving_weight_dtype=d)
        for d in ("int8", "auto")}
    want_tree = engines["int8"]._serving_copy(
        tck._tree_map(lambda t: t.to(torch.bfloat16), tree1))
    for pkg, root, tr in (("port", tmp_path / "port", tree1),
                          ("jax", tmp_path / "jax", trees[1])):
        os.makedirs(root)
        _publish(pkg, tr, str(root), 1, True)
        _publish(pkg, tr, str(root), 2, False)
        _publish(pkg, tr, str(root), 3, True)
        os.remove(os.path.join(root, "v3", tck.MANIFEST_NAME))
        _publish(pkg, tr, str(root), 4, True)
        shutil.rmtree(tck.quant_snapshot_path(str(root / "v4")))

    def case(version, dtype):
        got = []
        for pkg, cls, engs, ck in (
            ("port", GenerationServerWorker, engines, tck),
            ("jax", JGSW, jengines, jck),
        ):
            snap = str(tmp_path / pkg / f"v{version}")
            srv = _Stub(cls, engs[dtype], dtype, log)
            # v4's manifest still advertises the int8 tree removed since
            fmt, rpath, leaves = srv._negotiate(snap, ck.read_manifest(snap))
            got.append((fmt, os.path.basename(rpath), leaves is not None))
        assert got[0] == got[1], (version, dtype, got)
        return got[0]

    assert case(1, "int8") == ("int8", "v1-int8", True)
    assert case(2, "int8") == ("full", "v2", False)
    assert case(3, "int8") == ("full", "v3", False)
    assert case(4, "int8") == ("full", "v4", False)
    for v in (1, 2, 3, 4):
        assert case(v, "auto")[0] == "full"
    for dtype in ("int8", "auto"):
        srv = _Stub(GenerationServerWorker, engines[dtype], dtype, log)
        for v in (1, 2, 3):
            for staged in (True, False):
                restored = srv._load(dict(
                    path=str(tmp_path / "port" / f"v{v}"), format="params",
                    version=v), staged)
                assert tq.is_quantized_tree(restored) == (dtype == "int8")
                if dtype == "int8":
                    for (kp, a), (_, b) in zip(tck._flatten(restored),
                                               tck._flatten(want_tree)):
                        assert a.dtype == b.dtype and torch.equal(a, b), kp
    # a snapshot of another layout fails readably before any tensor is read
    other = dict(tree1, lm_head=dict(w=tree1["lm_head"]["w"][:, :32]))
    os.makedirs(tmp_path / "other")
    snap = _publish("port", other, str(tmp_path / "other"), 5, True)
    srv = _Stub(GenerationServerWorker, engines["int8"], "int8", log)
    with pytest.raises(RuntimeError, match="does not match"):
        srv._load(dict(path=snap, format="params", version=5), True)
