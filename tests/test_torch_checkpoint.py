"""The port's raw-parameter snapshots (``areal_tpu_torch/engine/checkpoint.py``)
against the JAX package's (``areal_tpu/engine/checkpoint.py``):

* save/load round trips: bit-exact in float32, and under a bfloat16 cast
  equal to the cast weights and to what the reference's own orbax round
  trip of the same weights gives;
* the chunked staged restore equal to the one-shot restore at several
  ``chunk_bytes``;
* ``wait=False``: the snapshot is the weights at the call, whatever the
  caller does to them afterwards, and lands at ``wait_for_saves``;
* manifests: the same leaf vocabulary and dtype names as the reference's
  on the same tree, ``read_manifest`` of a missing snapshot is None, and
  ``validate_manifest`` gives the reference's answers on its four kinds of
  problem (a float-width difference is none).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.engine import checkpoint as jck
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config
from areal_tpu_torch.engine import checkpoint as tck
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trees():
    """A tiny model's JAX tree (numpy) and its port (float32, CPU)."""
    jcfg = tiny_config(vocab_size=64, max_position_embeddings=64)
    np_tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    # random norm scales and biases, so every leaf holds distinct values
    np_tree = jax.tree.map(
        lambda x: (np.asarray(x) + rng.standard_normal(np.shape(x)) * 0.1)
        .astype(np.float32), np_tree,
    )
    cfg = port_config(jcfg)
    return np_tree, cfg, params_from_jax(np_tree, cfg, "cpu")


def _leaves(tree):
    return [leaf for _, leaf in tck._flatten(tree)]


def _assert_trees_equal(a, b):
    fa, fb = tck._flatten(a), tck._flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


@pytest.mark.parametrize("cast", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_round_trip_is_exact(tmp_path, trees, cast):
    _, _, params = trees
    snap = str(tmp_path / "v1")
    tck.save_params(params, snap, cast_dtype=cast)
    got = tck.load_params_like(params, snap)
    want = params if cast is None else [
        leaf.to(cast).to(leaf.dtype) for leaf in _leaves(params)
    ]
    if cast is None:
        _assert_trees_equal(got, want)
    else:
        for x, y in zip(_leaves(got), want):
            assert x.dtype == torch.float32 and torch.equal(x, y)


def test_bf16_round_trip_matches_reference(tmp_path, trees):
    """The reference's orbax snapshot of the same weights cast to bfloat16
    and restored onto float32 gives the port's values, leaf by leaf."""
    np_tree, cfg, params = trees
    jtree = jax.tree.map(jnp.asarray, np_tree)
    jck.save_params(jtree, str(tmp_path / "ref"), cast_dtype="bfloat16")
    ref = jax.device_get(jck.load_params_like(jtree, str(tmp_path / "ref")))
    tck.save_params(params, str(tmp_path / "port"), cast_dtype=torch.bfloat16)
    got = tck.load_params_like(params, str(tmp_path / "port"))
    want = params_from_jax(ref, cfg, "cpu")
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("chunk_bytes", [None, 0, 1, 300, 4096, 1 << 30])
def test_staged_restore_equals_one_shot(tmp_path, trees, chunk_bytes):
    _, _, params = trees
    snap = str(tmp_path / "v1")
    tck.save_params(params, snap, cast_dtype=torch.bfloat16)
    one_shot = tck.load_params_like(params, snap)
    staged = tck.load_params_staged(params, snap, chunk_bytes=chunk_bytes)
    _assert_trees_equal(staged, one_shot)


@pytest.mark.parametrize("chunk_bytes", [2, 300, 4096])
def test_staged_restore_through_small_buffers(tmp_path, trees, monkeypatch,
                                              chunk_bytes):
    """Host buffers far smaller than the leaves: each leaf is read in
    pieces across many buffer swaps, with the same result."""
    _, _, params = trees
    monkeypatch.setattr(tck, "_MIN_STAGE_BUFFER", 1)
    snap = str(tmp_path / "v1")
    tck.save_params(params, snap)
    staged = tck.load_params_staged(params, snap, chunk_bytes=chunk_bytes)
    _assert_trees_equal(staged, tck.load_params_like(params, snap))


def test_staged_restore_onto_a_bf16_template(tmp_path, trees):
    """A serving template (bf16 matrices, f32 norm scales) takes each
    leaf's own dtype from the template."""
    from areal_tpu_torch.models.convert import serving_params

    _, cfg, params = trees
    template = serving_params(params, dataclasses.replace(cfg, dtype="bfloat16"))
    snap = str(tmp_path / "v1")
    tck.save_params(params, snap, cast_dtype=torch.bfloat16)
    got = tck.load_params_staged(template, snap, chunk_bytes=512)
    for (k, x), (_, t), (_, p) in zip(tck._flatten(got), tck._flatten(template),
                                      tck._flatten(params)):
        assert x.dtype == t.dtype, k
        assert torch.equal(x, p.to(torch.bfloat16).to(t.dtype)), k


def test_async_save_snapshots_at_the_call(tmp_path, trees):
    _, _, params = trees
    snap = str(tmp_path / "v1")
    before = [leaf.clone() for leaf in _leaves(params)]
    work = [leaf.clone() for leaf in _leaves(params)]
    tree = tck._rebuild(params, {
        "/".join(k): w for (k, _), w in zip(tck._flatten(params), work)
    })
    tck.save_params(tree, snap, wait=False)
    for w in work:  # the trainer's next in-place update
        w.add_(1.0)
    tck.wait_for_saves()
    assert os.path.isfile(os.path.join(snap, tck.TENSORS_NAME))
    assert not any(n.endswith(f".tmp.{os.getpid()}") for n in os.listdir(snap))
    got = tck.load_params_like(params, snap)
    for x, y in zip(_leaves(got), before):
        assert torch.equal(x, y)
    tck.wait_for_saves()  # nothing pending: returns at once


def test_async_save_failure_raises_at_wait(tmp_path, trees):
    _, _, params = trees
    blocker = tmp_path / "v1"
    tck.save_params(params, str(blocker), wait=False)
    tck.wait_for_saves()
    # a directory where the tensor file must go makes the write fail
    os.remove(blocker / tck.TENSORS_NAME)
    os.makedirs(blocker / tck.TENSORS_NAME)
    tck.save_params(params, str(blocker), wait=False)
    with pytest.raises(OSError):
        tck.wait_for_saves()


def test_read_manifest_of_missing_snapshot_is_none(tmp_path):
    assert tck.read_manifest(str(tmp_path / "gone")) is None
    assert jck.read_manifest(str(tmp_path / "gone")) is None
    (tmp_path / "torn").mkdir()
    (tmp_path / "torn" / tck.MANIFEST_NAME).write_text("{not json")
    assert tck.read_manifest(str(tmp_path / "torn")) is None


def test_manifest_round_trip_and_layer_keys(tmp_path, trees):
    _, cfg, params = trees
    snap = str(tmp_path / "v7")
    written = tck.write_manifest(params, snap, version=7)
    got = tck.read_manifest(snap)
    assert got == written and got["version"] == 7
    assert "layers/0/attn/q/w" in got["leaves"]
    assert f"layers/{cfg.n_layers - 1}/mlp/down/w" in got["leaves"]
    assert got["leaves"]["embed/weight"] == {
        "shape": list(params["embed"]["weight"].shape), "dtype": "float32"}
    assert tck.validate_manifest(params, got) == []
    assert os.listdir(snap) == [tck.MANIFEST_NAME]


def _case_trees(case):
    """(template, published) as a numpy tree for the reference and a torch
    tree for the port, for one of the reference's kinds of problem."""
    rng = np.random.default_rng(0)
    base = {
        "embed": {"weight": rng.standard_normal((8, 4)).astype(np.float32)},
        "blk": {"w": rng.standard_normal((4, 4)).astype(np.float32),
                "q": rng.integers(-8, 8, (4, 2)).astype(np.int8)},
    }
    pub = {k: dict(v) for k, v in base.items()}
    if case == "missing":
        del pub["blk"]["w"]
    elif case == "unexpected":
        pub["blk"]["extra"] = np.zeros((2,), np.float32)
    elif case == "shape":
        pub["embed"]["weight"] = np.zeros((9, 4), np.float32)
    elif case == "dtype_class":
        pub["blk"]["q"] = np.zeros((4, 2), np.float32)
        pub["blk"]["w"] = np.zeros((4, 4), np.int32)
    elif case == "float_width":
        pub["embed"]["weight"] = np.zeros((8, 4), jnp.bfloat16)
        pub["blk"]["w"] = np.zeros((4, 4), np.float16)

    def to_torch(tree):
        return {k: to_torch(v) if isinstance(v, dict) else
                torch.from_numpy(np.asarray(v, np.float32)).to(
                    getattr(torch, str(np.asarray(v).dtype)))
                for k, v in tree.items()}

    return base, pub, to_torch(base), to_torch(pub)


@pytest.mark.parametrize(
    "case", ["same", "missing", "unexpected", "shape", "dtype_class",
             "float_width"])
def test_validate_manifest_matches_reference(tmp_path, case):
    np_tmpl, np_pub, t_tmpl, t_pub = _case_trees(case)
    jck.write_manifest(np_pub, str(tmp_path))
    ref_manifest = jck.read_manifest(str(tmp_path))
    port_manifest = tck.write_manifest(t_pub, str(tmp_path / "port"))
    # one vocabulary: the same keys, shapes and dtype names
    assert port_manifest == ref_manifest
    want = jck.validate_manifest(np_tmpl, ref_manifest)
    got = tck.validate_manifest(t_tmpl, port_manifest)
    assert got == want
    assert bool(got) == (case not in ("same", "float_width"))


def test_shape_mismatch_at_restore_names_the_leaf(tmp_path, trees):
    _, _, params = trees
    snap = str(tmp_path / "v1")
    tck.save_params(params, snap)
    other = tck._rebuild(params, {
        "/".join(k): (leaf[:-1] if k == ("embed", "weight") else leaf)
        for k, leaf in tck._flatten(params)
    })
    with pytest.raises(ValueError, match="embed/weight"):
        tck.load_params_staged(other, snap, chunk_bytes=1024)
    with pytest.raises(ValueError, match="embed/weight"):
        tck.load_params_like(other, snap)


def test_out_of_slice_parts_are_refused(tmp_path, trees):
    """The int8 sibling tree is published and advertised (its manifest
    entry names its dir and int8 layout), and an int8 engine serves it:
    the tree restores onto the engine's int8 template (the layout the
    entry advertises, checked as the staged restore checks it) and equals
    the engine's own quantization of the same weights; an ``"auto"``
    engine's int8 template has that layout too."""
    from areal_tpu_torch.engine.inference_server import (
        ContinuousBatchingEngine,
    )

    _, cfg, params = trees
    qpath = tck.quant_snapshot_path(str(tmp_path / "v1"))
    assert qpath.endswith("v1-int8")
    qavals = tck.save_quantized_params(params, qpath,
                                       cast_dtype=torch.bfloat16)
    entry = tck.quant_manifest_entry(qavals, qpath)
    manifest = tck.write_manifest(params, str(tmp_path / "v1"), version=1,
                                  serving_quant={"int8": entry})
    assert tck.read_manifest(str(tmp_path / "v1")) == manifest
    assert entry["dir"] == "v1-int8"
    assert entry["leaves"]["layers/0/attn/q/qw"]["dtype"] == "int8"
    assert entry["leaves"]["layers/0/attn/q/scale"]["dtype"] == "float32"
    assert os.path.exists(os.path.join(qpath, tck.TENSORS_NAME))
    eng = ContinuousBatchingEngine(
        cfg, params, max_batch=2, kv_cache_len=64, cache_mode="paged",
        page_size=16, device="cpu")
    assert tck.validate_manifest(eng.weight_restore_template("int8"),
                                 {"leaves": entry["leaves"]}) == []
    qeng = ContinuousBatchingEngine(
        cfg, params, max_batch=2, kv_cache_len=64, cache_mode="paged",
        page_size=16, device="cpu", serving_weight_dtype="int8")
    template = qeng.weight_restore_template("int8")
    assert template is qeng.params
    assert tck.validate_manifest(template, {"leaves": entry["leaves"]}) == []
    restored = qeng.prepare_weights(tck.load_params_staged(
        template, qpath, chunk_bytes=4096))
    ours = qeng._serving_copy(
        tck._tree_map(lambda t: t.to(torch.bfloat16), params))
    for (kp, a), (_, b) in zip(tck._flatten(restored), tck._flatten(ours)):
        assert a.dtype == b.dtype and torch.equal(a, b), kp
