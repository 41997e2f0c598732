"""The port's trainer math against the JAX package's, on the same
numpy-seeded inputs: the chunked head losses (with gradients), GAE (both
the tensor scan and the numpy reference), the PPO actor loss, reward
shaping, the KL controller, and clip + AdamW against optax.  Tolerances
are stated per test; all arithmetic is float32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.engine.optimizer import OptimizerConfig as JOptCfg
from areal_tpu.engine.optimizer import make_optimizer as jmake_optimizer
from areal_tpu.interfaces import ppo_functional as jpf
from areal_tpu.ops import gae as jgae
from areal_tpu.ops import loss as jloss
from areal_tpu_torch.engine.optimizer import OptimizerConfig, make_optimizer
from areal_tpu_torch.interfaces import ppo_functional as tpf
from areal_tpu_torch.ops import gae as tgae
from areal_tpu_torch.ops import loss as tloss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(t, j, tol, msg=""):
    np.testing.assert_allclose(
        np.asarray(t.detach() if isinstance(t, torch.Tensor) else t),
        np.asarray(j), rtol=tol, atol=tol, err_msg=msg,
    )


# ---------------------------------------------------------------------------
# chunked head losses (1e-5: the same float32 sums in chunk order)
# ---------------------------------------------------------------------------

N, D, V = 2500, 16, 301  # N is not a multiple of the 1024 chunk


@pytest.mark.parametrize("with_entropy", [True, False])
def test_per_token_logprobs_entropy(with_entropy):
    rng = _rng(0)
    h = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, N).astype(np.int32)
    cot = rng.standard_normal((2, N)).astype(np.float32)

    def jf(h, w):
        lp, ent = jloss.per_token_logprobs_entropy(
            h, w, jnp.asarray(lab), with_entropy=with_entropy
        )
        return lp, ent, jnp.sum(lp * cot[0]) + jnp.sum(ent * cot[1])

    jlp, jent, _ = jf(jnp.asarray(h), jnp.asarray(w))
    jgh, jgw = jax.grad(lambda a, b: jf(a, b)[2], argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w)
    )
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tlp, tent = tloss.per_token_logprobs_entropy(
        th, tw, torch.from_numpy(lab), with_entropy=with_entropy
    )
    (tlp * torch.from_numpy(cot[0]) + tent * torch.from_numpy(cot[1])).sum().backward()
    _close(tlp, jlp, 1e-5)
    _close(tent, jent, 1e-5)
    _close(th.grad, jgh, 1e-5)
    _close(tw.grad, jgw, 1e-5)


def test_masked_cross_entropy():
    rng = _rng(1)
    h = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, N).astype(np.int32)
    mask = rng.random(N) < 0.7
    js, jc = jloss.masked_cross_entropy(*map(jnp.asarray, (h, w, lab, mask)))
    jg = jax.grad(
        lambda a: jloss.masked_cross_entropy(
            a, jnp.asarray(w), jnp.asarray(lab), jnp.asarray(mask)
        )[0]
    )(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    ts, tc = tloss.masked_cross_entropy(
        th, *map(torch.from_numpy, (w, lab, mask))
    )
    ts.backward()
    _close(ts, js, 1e-5 * float(np.abs(js)))
    assert float(tc) == float(jc)
    _close(th.grad, jg, 1e-5)


# ---------------------------------------------------------------------------
# GAE (1e-5: the same recurrence in float32; 1e-6 between numpy copies)
# ---------------------------------------------------------------------------


def _gae_inputs(seed):
    rng = _rng(seed)
    B, T = 4, 37
    rewards = rng.standard_normal((B, T)).astype(np.float32)
    values = rng.standard_normal((B, T)).astype(np.float32)
    boot = rng.standard_normal(B).astype(np.float32)
    mask = np.zeros((B, T), np.float32)
    for b, (s, e) in enumerate([(0, 37), (3, 20), (10, 11), (0, 0)]):
        mask[b, s:e] = 1
    return rewards, values, boot, mask


@pytest.mark.parametrize("gamma,lam", [(1.0, 1.0), (0.99, 0.95)])
def test_gae(gamma, lam):
    args = _gae_inputs(2)
    ja, jr = jgae.gae_advantages_returns(*map(jnp.asarray, args), gamma, lam)
    ta, tr = tgae.gae_advantages_returns(*map(torch.from_numpy, args), gamma, lam)
    _close(ta, ja, 1e-5)
    _close(tr, jr, 1e-5)
    na, nr = tgae.gae_packed_numpy(*args, gamma, lam)
    ja2, jr2 = jgae.gae_packed_numpy(*args, gamma, lam)
    _close(na, ja2, 1e-6)
    _close(nr, jr2, 1e-6)
    m = args[3] > 0
    _close(ta.numpy()[m], na[m], 1e-5)


# ---------------------------------------------------------------------------
# PPO actor loss and reward shaping (1e-6: elementwise float32)
# ---------------------------------------------------------------------------


def _ppo_inputs(seed):
    rng = _rng(seed)
    shape = (3, 29)
    logp = (-rng.random(shape) * 3).astype(np.float32)
    old = (logp + rng.normal(0, 0.3, shape)).astype(np.float32)
    prox = (logp + rng.normal(0, 0.2, shape)).astype(np.float32)
    adv = rng.standard_normal(shape).astype(np.float32)
    mask = (rng.random(shape) < 0.8).astype(np.float32)
    return logp, old, prox, adv, mask


@pytest.mark.parametrize(
    "decoupled,cap,c_clip",
    [(False, None, None), (True, None, None), (True, 1.3, None),
     (False, None, 3.0), (True, 5.0, 3.0)],
)
def test_actor_loss_fn(decoupled, cap, c_clip):
    logp, old, prox, adv, mask = _ppo_inputs(3)
    kw = dict(c_clip=c_clip, behav_imp_weight_cap=cap)

    def jf(lp):
        return jpf.actor_loss_fn(
            lp, jnp.asarray(old), jnp.asarray(adv), 0.2, jnp.asarray(mask),
            proximal_logprobs=jnp.asarray(prox) if decoupled else None, **kw,
        )

    jl, jstat = jf(jnp.asarray(logp))
    jg = jax.grad(lambda lp: jf(lp)[0])(jnp.asarray(logp))
    tlp = torch.from_numpy(logp).requires_grad_()
    tl, tstat = tpf.actor_loss_fn(
        tlp, torch.from_numpy(old), torch.from_numpy(adv), 0.2,
        torch.from_numpy(mask),
        proximal_logprobs=torch.from_numpy(prox) if decoupled else None, **kw,
    )
    tl.backward()
    _close(tl, jl, 1e-6)
    _close(tlp.grad, jg, 1e-6)
    assert tstat.keys() == jstat.keys()
    for k in tstat:
        _close(tstat[k].float(), np.asarray(jstat[k], np.float32), 1e-6, k)


@pytest.mark.parametrize("mask_no_eos", [False, True])
def test_shape_rewards(mask_no_eos):
    rng = _rng(4)
    logp, ref = (rng.standard_normal((3, 11)).astype(np.float32) for _ in range(2))
    score = np.array([7.0, -0.5, 2.0], np.float32)
    tmask = np.zeros((3, 11), np.float32)
    tmask[0, 2:9] = tmask[1, 0:11] = tmask[2, 5:6] = 1
    no_eos = np.array([0, 1, 0], np.float32)
    args = (logp, ref, score, tmask)
    jk, jr = jpf.shape_rewards(
        0.1, 5.0, *map(jnp.asarray, args), seq_no_eos_mask=jnp.asarray(no_eos),
        mask_no_eos_with_zero=mask_no_eos,
    )
    tk, tr = tpf.shape_rewards(
        0.1, 5.0, *map(torch.from_numpy, args),
        seq_no_eos_mask=torch.from_numpy(no_eos),
        mask_no_eos_with_zero=mask_no_eos,
    )
    _close(tk, jk, 1e-6)
    _close(tr, jr, 1e-6)


def test_adaptive_kl_controller():
    j = jpf.AdaptiveKLController(0.1, 6.0, 1000.0)
    t = tpf.AdaptiveKLController(0.1, 6.0, 1000.0)
    for kl, n in [(3.0, 100), (9.0, 50), (6.5, 10), (100.0, 7)]:
        j.update(kl, n)
        t.update(kl, n)
        assert abs(t.value - j.value) < 1e-7


# ---------------------------------------------------------------------------
# clip + AdamW against optax (1e-6 relative: same float32 arithmetic order)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sched",
    [
        dict(lr_scheduler_type="constant", warmup_steps_proportion=0.0),
        dict(lr_scheduler_type="constant", warmup_steps_proportion=0.3),
        dict(lr_scheduler_type="linear", warmup_steps_proportion=0.2),
        dict(lr_scheduler_type="cosine", warmup_steps_proportion=0.1,
             min_lr_ratio=0.1),
    ],
    ids=["constant", "warmup", "linear", "cosine"],
)
def test_adamw_with_clipping_matches_optax(sched):
    rng = _rng(5)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(lr=1e-2, weight_decay=0.05, beta1=0.9, beta2=0.95, eps=1e-5,
              gradient_clipping=1.0, **sched)
    total = 10
    tx = jmake_optimizer(JOptCfg(**kw), total)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    opt = make_optimizer(OptimizerConfig(**kw), total)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt.init(tp)
    for step in range(5):
        # alternate small gradients (no clipping) and large ones (clipped)
        scale = 0.05 if step % 2 == 0 else 3.0
        grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        ref = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads))
        # step writes the clipped gradients into the tensors it is given
        norm = opt.step(tp, [torch.from_numpy(g.copy()) for g in grads])
        assert abs(float(norm) - ref) <= 1e-6 * ref
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    # the warm-up schedule gives lr 0 on the first update, as optax does
    if sched.get("warmup_steps_proportion"):
        assert opt.schedule(0) == 0.0


def test_out_of_slice_optimizer_options_are_refused():
    # the reference's options build (their arithmetic is held to optax in
    # test_torch_training_options.py); an optimizer it does not have is
    # refused as there, and a moment dtype torch does not store fails
    for kw in (dict(mu_dtype="bfloat16"), dict(nu_dtype="bfloat16"),
               dict(factored_second_moment=True), dict(type="sgd")):
        make_optimizer(OptimizerConfig(**kw), 10)
    with pytest.raises(NotImplementedError):
        OptimizerConfig(type="lion")
    with pytest.raises(ValueError, match="moment dtype"):
        make_optimizer(OptimizerConfig(mu_dtype="int8"), 10)
