"""The port's training forward (``hidden_states``, ``forward``,
``logprobs_of_labels``) and its gradients against the JAX package's, at a
tiny float32 config, on the same weights (the JAX float32 tree carried
across by ``params_from_jax``) and the same packed
multi-segment rows plus padding (the JAX package's ``pack_batch``).

Outputs are compared on real tokens (padding queries differ by contract:
see ``tests/test_torch_flash_attention.py``), to 1e-4.  Gradients of a
scalar loss over real tokens, with respect to every parameter leaf, with
``remat`` on and off, to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.engine import batching as jbatching
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.models import transformer as tt
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.convert import params_from_jax

TOL = 1e-4


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
    """The JAX init tree as numpy, with zero biases and unit norm scales
    replaced by random values so those paths are exercised."""
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


def packed_batch(vocab, seed=0):
    lens = [9, 23, 5, 17, 30, 12]
    rng = np.random.default_rng(seed)
    sample = JSample.from_default(
        lens, [f"s{i}" for i in range(len(lens))],
        {"packed_input_ids": rng.integers(0, vocab, sum(lens)).astype(np.int32)},
    )
    pb = jbatching.pack_batch(sample, fixed_len=40)
    assert (pb.seg_ids.max(axis=1) > 1).any() and (pb.seg_ids == 0).any()
    return pb


#: tiny JAX configs: untied head, and tied embedding with qkv bias
CONFIGS = {
    "untied": dict(),
    "tied_bias": dict(tied_embedding=True, use_attention_bias=True),
}


def _setup(name, remat=False):
    jcfg = jtiny(vocab_size=97, remat=remat, **CONFIGS[name])
    tree = randomized_tree(jcfg, 0)
    cfg = port_config(jcfg)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, params_from_jax(
        tree, cfg, "cpu"
    )


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_hidden_and_logprobs(name):
    jcfg, jparams, cfg, params = _setup(name)
    assert params["layers"][0]["attn"]["q"]["w"].dtype == torch.float32
    pb = packed_batch(cfg.vocab_size)
    args = (pb.tokens, pb.positions, pb.seg_ids)
    real = pb.seg_ids != 0
    with torch.no_grad():
        h = tt.hidden_states(params, cfg, *map(_t, args))
        lg = tt.forward(params, cfg, *map(_t, args))
        lp = tt.logprobs_of_labels(params, cfg, *map(_t, args), chunk=16)
    jargs = tuple(map(jnp.asarray, args))
    np.testing.assert_allclose(
        h.numpy()[real], np.asarray(jt.hidden_states(jparams, jcfg, *jargs))[real],
        rtol=TOL, atol=TOL,
    )
    np.testing.assert_allclose(
        lg.numpy()[real], np.asarray(jt.forward(jparams, jcfg, *jargs))[real],
        rtol=TOL, atol=TOL,
    )
    src = real[:, :-1]
    np.testing.assert_allclose(
        lp.numpy()[src],
        np.asarray(jt.logprobs_of_labels(jparams, jcfg, *jargs))[src],
        rtol=TOL, atol=TOL,
    )


def _jax_leaves_by_layer(tree, n_layers):
    """The JAX grad tree in the port's layout: ``layers`` unstacked."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = [
        jax.tree.map(lambda a: np.asarray(a)[l], tree["layers"])
        for l in range(n_layers)
    ]
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_parameter_gradients(name, remat):
    jcfg, jparams, cfg, params = _setup(name, remat=remat)
    pb = packed_batch(cfg.vocab_size, seed=1)
    args = (pb.tokens, pb.positions, pb.seg_ids)
    rng = np.random.default_rng(2)
    w = rng.standard_normal(pb.tokens.shape + (cfg.vocab_size,)).astype(np.float32)
    w *= (pb.seg_ids != 0)[..., None]

    def jloss(p):
        return jnp.sum(jt.forward(p, jcfg, *map(jnp.asarray, args)) * w)

    jg = _jax_leaves_by_layer(jax.grad(jloss)(jparams), cfg.n_layers)
    leaves = dict(_flat(params))
    for t in leaves.values():
        t.requires_grad_(True)
    (tt.forward(params, cfg, *map(_t, args)) * torch.from_numpy(w)).sum().backward()
    jleaves = dict(_flat(jg))
    assert leaves.keys() == jleaves.keys()
    for k, t in leaves.items():
        np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(jleaves[k]), rtol=TOL, atol=TOL,
            err_msg=k,
        )
