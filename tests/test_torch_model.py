"""Per-module parity of the torch port's transformer building blocks with
the JAX package's, at the flagship tiny config in float32, on the same
weights (the JAX param tree carried across by ``params_from_jax``) and the
same numpy-seeded inputs.  Tolerance 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from areal_tpu.models import transformer as jt
from areal_tpu_torch.models import transformer as tt
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.convert import params_from_jax, serving_params

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_config(jcfg) -> TransformerConfig:
    names = {f.name for f in dataclasses.fields(TransformerConfig)}
    return TransformerConfig(
        **{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names}
    )


def randomized_tree(jcfg, seed):
    """The JAX init tree as numpy, with its zero biases and unit norm
    scales replaced by random values so those paths are exercised."""
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def fill(t):
        for k, v in t.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "b":
                t[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "scale":
                t[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    fill(tree)
    return tree


@pytest.fixture(scope="module")
def model():
    jcfg = __graft_entry__._flagship_tiny()
    tree = randomized_tree(jcfg, 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    cfg = port_config(jcfg)
    return jcfg, jparams, cfg, params_from_jax(tree, cfg, "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(
        t.detach().numpy(), np.asarray(j), rtol=TOL, atol=TOL
    )


def _layer(jparams, l):
    return jax.tree.map(lambda a: a[l], jparams["layers"])


def test_norm(model):
    jcfg, jparams, cfg, params = model
    x = _x((2, 5, cfg.hidden_dim))
    _close(
        tt._norm(torch.from_numpy(x), params["layers"][1]["attn_norm"], cfg),
        jt._norm(jnp.asarray(x), _layer(jparams, 1)["attn_norm"], jcfg),
    )


def test_head_norm():
    x = _x((2, 3, 4, 16))
    scale = np.random.default_rng(2).uniform(0.5, 1.5, 16).astype(np.float32)
    _close(
        tt._head_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
        jt._head_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
    )


def test_rope(model):
    *_, cfg, _ = model
    pos = np.random.default_rng(3).integers(0, 200, (2, 7)).astype(np.int32)
    x = _x((2, 7, 4, cfg.head_dim))
    cos_t, sin_t = tt.rope_tables(torch.from_numpy(pos), cfg.rotary_base,
                                  cfg.head_dim)
    cos_j, sin_j = jt.rope_tables(jnp.asarray(pos), cfg.rotary_base,
                                  cfg.head_dim)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    _close(tt.rope_apply(torch.from_numpy(x), cos_t, sin_t),
           jt.rope_apply(jnp.asarray(x), cos_j, sin_j))


def test_attn_qkv(model):
    jcfg, jparams, cfg, params = model
    h = _x((2, 6, cfg.hidden_dim))
    pos = np.tile(np.arange(3, 9, dtype=np.int32), (2, 1))
    got = tt._attn_qkv(cfg, params["layers"][0], torch.from_numpy(h),
                       torch.from_numpy(pos), None)
    want = jt._attn_qkv(jcfg, _layer(jparams, 0), jnp.asarray(h),
                        jnp.asarray(pos), None)
    for t, j in zip(got, want):
        _close(t, j)


def test_mlp_block(model):
    jcfg, jparams, cfg, params = model
    h = _x((2, 4, cfg.hidden_dim))
    want, _ = jt._mlp_block(jcfg, _layer(jparams, 1), jnp.asarray(h))
    _close(tt._mlp_block(cfg, params["layers"][1], torch.from_numpy(h)), want)


def test_embed_and_head(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    _close(
        tt._embed(params, cfg, torch.from_numpy(tok), torch.from_numpy(pos)),
        jt._embed(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos)),
    )
    x = _x((2, 3, cfg.hidden_dim), seed=5)
    _close(tt._head(params, cfg, torch.from_numpy(x)),
           jt._head(jparams, jcfg, jnp.asarray(x)))


def test_tied_head():
    jcfg = dataclasses.replace(
        __graft_entry__._flagship_tiny(), tied_embedding=True
    )
    tree = randomized_tree(jcfg, 1)
    cfg = port_config(jcfg)
    params = params_from_jax(tree, cfg, "cpu")
    x = _x((2, 3, cfg.hidden_dim), seed=6)
    _close(tt._head(params, cfg, torch.from_numpy(x)),
           jt._head(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x)))


def test_convert_layout(model):
    jcfg, jparams, cfg, params = model
    assert len(params["layers"]) == cfg.n_layers
    w = params["layers"][1]["attn"]["q"]["w"]
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jparams["layers"]["attn"]["q"]["w"][1])
    )
    # bf16 models store matrices at model dtype, norm scales in float32
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = serving_params(
        params_from_jax(jax.device_get(jparams), bcfg, "cpu"), bcfg)
    assert bparams["layers"][0]["mlp"]["up"]["w"].dtype == torch.bfloat16
    assert bparams["layers"][0]["attn_norm"]["scale"].dtype == torch.float32


def test_init_params_matches_reference_tree(model):
    jcfg, jparams, cfg, _ = model
    mine = tt.init_params(cfg, 0, torch.device("cpu"))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)

    ref = shapes(jax.device_get(jparams))
    ref_layer = jax.tree.map(
        lambda s: s[1:], ref["layers"], is_leaf=lambda x: isinstance(x, tuple)
    )
    got = shapes({k: v for k, v in mine.items() if k != "layers"})
    assert got == {k: v for k, v in ref.items() if k != "layers"}
    assert all(shapes(lp) == ref_layer for lp in mine["layers"])
