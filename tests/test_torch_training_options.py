"""The port's training options against the JAX package's, on the CPU:

- the optimizer's moment options over N steps of the same gradients
  against ``areal_tpu.engine.optimizer.make_optimizer`` (optax): float32
  Adam, SGD and the factored second moment to 1e-6; bf16 ``mu`` and
  ``nu`` to the tolerance stated at ``MOMENT_TOL`` (a bf16 moment stored
  from float32 values that differ in the last bit can round one bf16
  step apart); and ``opt_state_bytes``;
- every remat policy's gradients against ``none``'s and against the JAX
  package's under the same policy, in an SFT loss through the training
  forward;
- ``pack_capacity > 0``: the engine's row layout and two SFT steps
  against the JAX engine's;
- the train-state checkpoint with bf16 and factored moments: dtypes,
  shapes and values restored bit for bit, and the next step equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.engine.optimizer import OptimizerConfig as JOptCfg
from areal_tpu.engine.optimizer import make_optimizer as jmake_optimizer
from areal_tpu.engine.optimizer import opt_state_bytes as jopt_state_bytes
from areal_tpu_torch.engine.optimizer import (
    OptimizerConfig,
    make_optimizer,
    opt_state_bytes,
)

#: per option: (rtol, atol) on the parameters after the steps.  float32
#: Adam, SGD and the factored moment repeat optax's arithmetic (1e-6
#: relative).  A bf16-stored moment can round one bf16 step (2^-8
#: relative) apart where the float32 value before the rounding differs in
#: its last bit (the clipped gradients come from a global norm summed in
#: another order), which moves that element's later updates by a few
#: parts in 1e3 of lr: at lr 1e-3 over 5 steps, 1e-6 absolute bounds it
#: (1.8e-7 measured on this data).
MOMENT_TOL = {
    "fp32": (1e-6, 1e-7),
    "sgd": (1e-6, 1e-7),
    "mu_bf16": (1e-6, 1e-6),
    "nu_bf16": (1e-6, 1e-6),
    "mu_nu_bf16": (1e-6, 1e-6),
    "factored": (1e-6, 1e-7),
    "factored_bf16": (1e-6, 1e-6),
}
OPTIONS = {
    "fp32": {},
    "sgd": dict(type="sgd"),
    "mu_bf16": dict(mu_dtype="bfloat16"),
    "nu_bf16": dict(nu_dtype="bfloat16"),
    "mu_nu_bf16": dict(mu_dtype="bfloat16", nu_dtype="bfloat16"),
    "factored": dict(factored_second_moment=True, factored_min_dim=8),
    "factored_bf16": dict(factored_second_moment=True, factored_min_dim=8,
                          mu_dtype="bfloat16", nu_dtype="bfloat16"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# optimizer options against optax
# ---------------------------------------------------------------------------

L, D, N, M, V = 3, 16, 12, 24, 10


def _jax_tree(rng):
    """A reference-layout tree: stacked [L, ...] layer leaves (a factorable
    matrix, one too narrow, a bias and a norm scale) beside an embedding
    and a value head, which stay exact."""
    f = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    return {
        "embed": f(V, D),
        "layers": {"w": f(L, N, M), "narrow": f(L, N, 4), "b": f(L, M),
                   "scale": f(L, D)},
        "value_head": f(D, 16),
    }


def _port_leaves(tree):
    """The port's layout of the same tree (per-layer tensors), in the
    engine's leaf order, and the mask of per-layer leaves."""
    leaves, in_layers = [torch.from_numpy(tree["embed"].copy())], [False]
    for l in range(L):
        for k in ("w", "narrow", "b", "scale"):
            leaves.append(torch.from_numpy(tree["layers"][k][l].copy()))
            in_layers.append(True)
    leaves.append(torch.from_numpy(tree["value_head"].copy()))
    in_layers.append(False)
    return leaves, in_layers


@pytest.mark.parametrize("option", list(OPTIONS))
def test_optimizer_options_equal_optax(option):
    kw = dict(lr=1e-3, lr_scheduler_type="cosine", warmup_steps_proportion=0.2,
              **OPTIONS[option])
    total, steps = 10, 5
    rng = np.random.default_rng(0)
    tree = _jax_tree(rng)
    tx = jmake_optimizer(JOptCfg(**kw), total)
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    opt = make_optimizer(OptimizerConfig(**kw), total)
    tp, in_layers = _port_leaves(tree)
    opt.init(tp, factored=in_layers)
    assert opt_state_bytes(opt) == jopt_state_bytes(state)
    for step in range(steps):
        # small gradients (no clipping) and large ones (clipped) in turn
        scale = 0.05 if step % 2 == 0 else 3.0
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
            tree)
        upd, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        tg, _ = _port_leaves(grads)
        opt.step(tp, tg)
    rtol, atol = MOMENT_TOL[option]
    want, _ = _port_leaves(jax.tree.map(np.asarray, jp))
    for i, (t, w) in enumerate(zip(tp, want)):
        np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{option}: leaf {i}")
    if option == "sgd":
        assert opt.state_tensors() == []
        return
    # the stored moments keep their dtypes; the factored ones are the
    # per-layer matrices wide enough, as in the reference
    mu_dt = torch.bfloat16 if kw.get("mu_dtype") else torch.float32
    nu_dt = torch.bfloat16 if kw.get("nu_dtype") else torch.float32
    assert all(m.dtype == mu_dt for m in opt.mu)
    factored = [isinstance(n, dict) for n in opt.nu]
    if kw.get("factored_second_moment"):
        assert factored == [False] + [True, False, False, False] * L + [False]
    else:
        assert not any(factored)
    for n in opt.nu:
        for t in (n.values() if isinstance(n, dict) else [n]):
            assert t.dtype == nu_dt


def test_opt_state_bytes_shrink_with_the_options():
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.models.transformer import init_params

    cfg = tiny_config(vocab_size=64, hidden_dim=64, intermediate_dim=128,
                      n_q_heads=8, n_kv_heads=8)
    sizes = {}
    for name, kw in (("fp32", {}), ("bf16", dict(mu_dtype="bfloat16",
                                                  nu_dtype="bfloat16")),
                     ("factored", dict(factored_second_moment=True,
                                       factored_min_dim=64)),
                     ("sgd", dict(type="sgd"))):
        e = TrainEngine(cfg, None, init_params(cfg, 0, "cpu", dtype=torch.float32),
                        OptimizerConfig(**kw), 10, device="cpu")
        sizes[name] = opt_state_bytes(e.opt)
    n_params = sum(p.numel() for p in e._leaves)
    assert sizes["fp32"] == 8 * n_params + 8
    assert sizes["bf16"] == 4 * n_params + 8
    assert sizes["sgd"] == 4
    assert 4 * n_params + 8 < sizes["factored"] < sizes["fp32"]


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------


def _sft_batch(vocab, B=2, T=16, seed=0):
    rng = np.random.default_rng(seed)
    seg = np.ones((B, T), np.int32)
    seg[1, 10:] = 2
    seg[1, 14:] = 0
    pos = np.where(seg[:, :] == 2, np.arange(T) - 10, np.arange(T)).astype(np.int32)
    pos[seg == 0] = 0
    return {
        "tokens": rng.integers(1, vocab, (B, T)).astype(np.int32),
        "positions": pos,
        "seg_ids": seg,
        "prompt_mask": np.zeros((B, T), bool),
    }


def _torch_grads(cfg, params, batch):
    from areal_tpu_torch.interfaces.sft_interface import sft_loss_fn

    for p in _leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss_sum, denom, _ = sft_loss_fn(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    (loss_sum / denom).backward()
    return [p.grad.clone() for p in _leaves(params)]


def _leaves(tree):
    from areal_tpu_torch.engine.train_engine import tree_leaves

    return tree_leaves(tree)


@pytest.mark.parametrize("policy", ["none", "offload_qkv", "attn_out", "mlp",
                                    "qkv_attn", "dots"])
def test_remat_policy_gradients(policy):
    from areal_tpu.interfaces.sft_interface import sft_loss_fn as jsft_loss
    from areal_tpu.models import transformer as jt
    from areal_tpu.models.config import tiny_config as jtiny
    from areal_tpu_torch.models import remat
    from areal_tpu_torch.models.convert import params_from_jax
    from tests.test_torch_train_engine import _flat, _port_layout
    from tests.test_torch_train_model import port_config

    assert remat.POLICY_NAMES == ("none", "offload_qkv", "attn_out", "mlp",
                                  "qkv_attn", "dots")
    jcfg = jtiny(vocab_size=64, use_attention_bias=True)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    batch = _sft_batch(64)
    cfg0 = port_config(jcfg)
    params = params_from_jax(tree, cfg0, "cpu")
    g_plain = _torch_grads(dataclasses.replace(cfg0, remat=False), params, batch)
    g_pol = _torch_grads(
        dataclasses.replace(cfg0, remat=True, remat_policy=policy), params, batch)
    for a, b in zip(g_pol, g_plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)

    jcfg_p = dataclasses.replace(jcfg, remat=True, remat_policy=policy)

    def loss(p):
        ls, dn, _ = jsft_loss(p, jcfg_p, {k: jnp.asarray(v) for k, v in batch.items()})
        return ls / dn

    jg = dict(_flat(_port_layout(jax.device_get(jax.grad(loss)(
        jax.tree.map(jnp.asarray, tree))), cfg0.n_layers)))
    tg = dict(zip([k for k, _ in _flat(params)], g_pol))
    for k, g in tg.items():
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=1e-4, atol=2e-6,
                                   err_msg=f"{policy}: {k}")


#: per layer, what each policy's backward runs again: (matrix products
#: without batch dimensions, attention forwards) of the layer's seven
#: products.  ``dots`` keeps every product and recomputes the attention;
#: ``qkv_attn`` and ``offload_qkv`` keep the attention.  A non-reentrant
#: recompute stops at its segment's last save, which a product makes
#: before it runs: a segment that ends in one (the MLP's down projection;
#: ``mlp``'s output projection too) skips it.  ``offload_qkv``'s MLP half
#: is a reentrant checkpoint, which runs its segment whole.
RECOMPUTED = {"none": (6, 1), "offload_qkv": (7, 0), "attn_out": (6, 1),
              "mlp": (5, 1), "qkv_attn": (6, 0), "dots": (0, 1)}


@pytest.mark.parametrize("policy", sorted(RECOMPUTED))
def test_remat_policy_recomputes_what_it_names(policy, monkeypatch):
    from torch.utils._python_dispatch import TorchDispatchMode

    from areal_tpu_torch.interfaces.sft_interface import sft_loss_fn
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.transformer import init_params
    from areal_tpu_torch.ops import flash_attention as fa_mod

    inside = []
    calls = []
    plain = fa_mod.flash_attention

    def flash(*a, **kw):
        calls.append(1)
        inside.append(1)
        try:
            return plain(*a, **kw)
        finally:
            inside.pop()

    monkeypatch.setattr(fa_mod, "flash_attention", flash)

    class CountProducts(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside and func in (torch.ops.aten.mm.default,
                                       torch.ops.aten.addmm.default):
                CountProducts.n += 1
            return func(*args, **(kwargs or {}))

    cfg = tiny_config(vocab_size=64)
    params = init_params(cfg, 0, "cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _sft_batch(64).items()}

    def backward_work(c):
        for p in _leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss_sum, denom, _ = sft_loss_fn(params, c, batch)
        CountProducts.n, calls[:] = 0, []
        with CountProducts():
            (loss_sum / denom).backward()
        return CountProducts.n, len(calls)

    mm0, fa0 = backward_work(dataclasses.replace(cfg, remat=False))
    mm1, fa1 = backward_work(
        dataclasses.replace(cfg, remat=True, remat_policy=policy))
    assert fa0 == 0
    assert (mm1 - mm0, fa1) == tuple(
        cfg.n_layers * n for n in RECOMPUTED[policy])


def test_remat_policy_refusals_and_the_no_grad_path():
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.remat import policy_for
    from areal_tpu_torch.models.transformer import forward, init_params

    with pytest.raises(ValueError, match="remat_policy"):
        tiny_config(remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        policy_for("qkv")
    # under no_grad no policy runs (an inference forward checkpoints
    # nothing), and the output equals the plain forward's
    cfg = tiny_config(vocab_size=64, remat=True, remat_policy="offload_qkv")
    params = init_params(cfg, 0, "cpu", dtype=torch.float32)
    b = {k: torch.from_numpy(v) for k, v in _sft_batch(64).items()}
    with torch.no_grad():
        a = forward(params, cfg, b["tokens"], b["positions"], b["seg_ids"])
        p = forward(params, dataclasses.replace(cfg, remat=False),
                    b["tokens"], b["positions"], b["seg_ids"])
    assert torch.equal(a, p)


# ---------------------------------------------------------------------------
# pack_capacity
# ---------------------------------------------------------------------------


def _sft_sample(n=10, seed=0, vocab=64):
    from areal_tpu.api.data import SequenceSample as JSample

    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 30, n)
    toks = rng.integers(1, vocab, int(lens.sum())).astype(np.int32)
    pmask = np.concatenate([np.arange(L) < int(rng.integers(1, L - 1)) for L in lens])
    return JSample.from_default(
        seqlens=[int(l) for l in lens], ids=[f"s{i}" for i in range(n)],
        data={"packed_input_ids": toks, "prompt_mask": pmask})


def test_pack_capacity_rows_and_steps_equal_the_jax_engines():
    from areal_tpu.api.data import MicroBatchSpec as JSpec
    from areal_tpu.base.topology import MeshSpec
    from areal_tpu.engine.train_engine import TrainEngine as JEngine
    from areal_tpu.interfaces.sft_interface import sft_loss_fn as jsft
    from areal_tpu.models import transformer as jt
    from areal_tpu.models.config import tiny_config as jtiny
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.engine import backend
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.interfaces.sft_interface import sft_loss_fn
    from areal_tpu_torch.models.convert import params_from_jax
    from tests.test_torch_sft_dpo import _to_port
    from tests.test_torch_train_engine import _flat, _port_layout
    from tests.test_torch_train_model import port_config

    opt = dict(lr=5e-3, warmup_steps_proportion=0.0)
    jcfg = jtiny(vocab_size=64, max_position_embeddings=512)
    cfg = port_config(jcfg)
    mesh = MeshSpec(data=1, fsdp=1, model=1).make_mesh(jax.devices()[:1])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(0)))
    je = JEngine(jcfg, mesh, jax.tree.map(jnp.asarray, tree), JOptCfg(**opt),
                 100, pack_capacity=128)
    te = TrainEngine(cfg, None, params_from_jax(tree, cfg, "cpu"),
                     OptimizerConfig(**opt), 100, device="cpu", pack_capacity=128)
    js = _sft_sample()
    ts = _to_port(js)
    jpb = je._pad(js, "packed_input_ids")
    tpb = te._pad(ts, "packed_input_ids")
    assert tpb.tokens.shape == jpb.tokens.shape == (2, 128)
    for f in ("tokens", "positions", "seg_ids", "seg_rows", "seg_starts",
              "seg_lens"):
        np.testing.assert_array_equal(getattr(tpb, f), getattr(jpb, f), err_msg=f)
    # without the capacity the rows are the longest sequence's bucket
    plain = TrainEngine(cfg, None, params_from_jax(tree, cfg, "cpu"), None,
                        device="cpu")
    assert plain._pad(ts, "packed_input_ids").tokens.shape[1] < 128
    for step, n_mbs in enumerate((1, 2)):
        jst = je.train_batch(js, jsft, JSpec(n_mbs=n_mbs))
        tst = te.train_batch(_to_port(js), sft_loss_fn, MicroBatchSpec(n_mbs=n_mbs))
        assert tst["n_tokens"] == jst["n_tokens"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(tst[k], jst[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {step}: {k}")
    jp = dict(_flat(_port_layout(jax.device_get(je.params), cfg.n_layers)))
    for k, t in _flat(te.params):
        np.testing.assert_allclose(t.detach().numpy(), jp[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # both backends carry the option into their engines
    for name, b in (("train", backend.TrainBackend(pack_capacity=256,
                                                   device="cpu")),
                    ("inference", backend.InferenceBackend(pack_capacity=256,
                                                           device="cpu"))):
        from areal_tpu_torch.api import model_api
        from areal_tpu_torch.models.transformer import init_params

        m = model_api.Model(name, None)
        m.model_cfg = cfg
        m.init_params = init_params(cfg, 0, "cpu", dtype=torch.float32)
        b._initialize(m, model_api.FinetuneSpec(1, 10, 10))
        assert m.engine.pack_capacity == 256
        assert m.engine._pad(ts, "packed_input_ids").tokens.shape[1] == 256


# ---------------------------------------------------------------------------
# the train-state checkpoint with every moment kind
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_kw", [
    dict(mu_dtype="bfloat16", nu_dtype="bfloat16"),
    dict(mu_dtype="bfloat16", factored_second_moment=True, factored_min_dim=16),
    dict(type="sgd"),
], ids=["bf16_moments", "factored", "sgd"])
def test_train_state_round_trip_keeps_every_moment_kind(tmp_path, opt_kw):
    from areal_tpu_torch.api.data import MicroBatchSpec
    from areal_tpu_torch.engine.train_engine import TrainEngine
    from areal_tpu_torch.interfaces.sft_interface import sft_loss_fn
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.transformer import init_params
    from tests.test_torch_sft_dpo import _to_port

    cfg = tiny_config(vocab_size=64, max_position_embeddings=512)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0, **opt_kw)
    sample = _to_port(_sft_sample(n=6, seed=2))

    def engine(seed):
        return TrainEngine(cfg, None, init_params(cfg, seed, "cpu",
                                                  dtype=torch.float32),
                           opt_cfg, 100, device="cpu")

    a = engine(0)
    for _ in range(2):
        a.train_batch(sample, sft_loss_fn, MicroBatchSpec(n_mbs=2))
    ckpt = str(tmp_path / "globalstep2")
    a.save_train_state(ckpt)
    b = engine(9)
    assert b.load_train_state(ckpt)
    assert b.opt.count == a.opt.count == 2 and b.version == a.version
    sa, sb = a.opt.state_tensors(), b.opt.state_tensors()
    assert len(sa) == len(sb)
    if opt_kw.get("factored_second_moment"):
        assert any(isinstance(n, dict) for n in b.opt.nu)
    for x, y in zip(sa + a._leaves, sb + b._leaves):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16
                           else x.detach(), y.view(torch.uint8)
                           if y.dtype == torch.bfloat16 else y.detach())
    s1 = a.train_batch(sample, sft_loss_fn, MicroBatchSpec(n_mbs=2))
    s2 = b.train_batch(_to_port(_sft_sample(n=6, seed=2)), sft_loss_fn,
                       MicroBatchSpec(n_mbs=2))
    assert s1["loss"] == s2["loss"] and s1["grad_norm"] == s2["grad_norm"]
    for x, y in zip(a._leaves, b._leaves):
        assert torch.equal(x, y)
    # a state of another kind is refused, not cast
    other = TrainEngine(cfg, None, init_params(cfg, 0, "cpu", dtype=torch.float32),
                        OptimizerConfig(lr=1e-3), 100, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        other.load_train_state(ckpt)
