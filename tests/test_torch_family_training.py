"""Training the families whose attention the flash kernel gained last:
Gemma (head_dim 256) and Mistral (a sliding window), on the CPU, the port
against the JAX package.

Two ``SFTInterface`` train steps (one micro-batch, then two) of a tiny
2-layer model of each family from the same float32 weights (the JAX init
carried across by ``params_from_jax``), on numpy-seeded packed sequences,
several of them longer than Mistral's window: the steps' loss, grad norm
and token counts, and every parameter after them, to 1e-4.  The port's
forward puts both families through ``flash_attention`` (its plain version
here; the CUDA kernel on a card, held against that plain version by
``chip_smoke.py``), the window included; the JAX package's trainer masks
dense attention for the window.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api import model_api as jmodel_api
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.api.data import SequenceSample as JSample
from areal_tpu.base.topology import MeshSpec
from areal_tpu.engine.optimizer import OptimizerConfig as JOptCfg
from areal_tpu.engine.train_engine import TrainEngine as JEngine
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu_torch.api import model_api
from areal_tpu_torch.api.data import MicroBatchSpec
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.train_engine import TrainEngine
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_sft_dpo import _to_port
from tests.test_torch_train_engine import _flat, _port_layout
from tests.test_torch_train_model import port_config

TOL = 1e-4
VOCAB = 64
WINDOW = 16
OPT = dict(lr=5e-3, warmup_steps_proportion=0.0)

#: the two families at tiny widths: Gemma's head_dim 256 (gelu, tied and
#: scaled embeddings, one KV head) and Mistral's sliding window (under
#: remat, so the checkpointed layer runs the windowed attention again)
FAMILIES = {
    "gemma": dict(hidden_dim=64, n_q_heads=2, n_kv_heads=1, head_dim=256,
                  intermediate_dim=96, activation="gelu",
                  tied_embedding=True, embed_scale=math.sqrt(64)),
    "mistral": dict(sliding_window=WINDOW, remat=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(family, seed):
    jcfg = jtiny(vocab_size=VOCAB, **FAMILIES[family])
    cfg = port_config(jcfg)
    mesh = MeshSpec(data=1, fsdp=1, model=1).make_mesh(jax.devices()[:1])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(seed)))
    je = JEngine(jcfg, mesh, jax.tree.map(jnp.asarray, tree), JOptCfg(**OPT),
                 100)
    te = TrainEngine(cfg, None, params_from_jax(tree, cfg, "cpu"),
                     OptimizerConfig(**OPT), 100, device="cpu")
    return (jmodel_api.Model("actor", je, None, mesh,
                             ft_spec=jmodel_api.FinetuneSpec(1, 100, 10)),
            model_api.Model("actor", te,
                            ft_spec=model_api.FinetuneSpec(1, 100, 10)),
            cfg)


def _sft_sample(seed, n=6):
    """Sequences of 5-40 tokens (most longer than the window) with prompt
    masks."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 41, n)
    toks = rng.integers(1, VOCAB, int(lens.sum())).astype(np.int32)
    pmask = np.concatenate(
        [np.arange(L) < int(rng.integers(1, L // 2)) for L in lens])
    js = JSample.from_default(
        seqlens=[int(l) for l in lens], ids=[f"s{i}" for i in range(n)],
        data={"packed_input_ids": toks, "prompt_mask": pmask})
    return js, _to_port(js)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sft_steps_equal_the_jax_packages(family, monkeypatch):
    from areal_tpu.interfaces.sft_interface import SFTInterface as JSFT
    from areal_tpu_torch.interfaces.sft_interface import SFTInterface

    # every attention of the port's steps goes through the flash wrapper,
    # with the family's window
    windows = []
    real = tfa.flash_attention

    def seen(q, k, v, seg_ids, window=None):
        windows.append((q.shape[-1], window))
        return real(q, k, v, seg_ids, window=window)

    monkeypatch.setattr(tfa, "flash_attention", seen)
    jm, tm, cfg = _models(family, seed=3)
    ji, ti = JSFT(), SFTInterface()
    for step, n_mbs in enumerate((1, 2)):
        js, ts = _sft_sample(seed=11 + step)
        if family == "mistral":
            assert max(ts.seqlens["packed_input_ids"])[0] > WINDOW
        jst = ji.train_step(jm, js, JSpec(n_mbs=n_mbs))
        tst = ti.train_step(tm, ts, MicroBatchSpec(n_mbs=n_mbs))
        assert tst["n_tokens"] == jst["n_tokens"] > 0
        for k in ("loss", "grad_norm", "nll_sum", "n_valid_tokens"):
            np.testing.assert_allclose(tst[k], jst[k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}: {k}")
    assert windows and set(windows) == {(cfg.head_dim, cfg.sliding_window)}
    jp = dict(_flat(_port_layout(jax.device_get(jm.engine.params),
                                 cfg.n_layers)))
    for k, t in _flat(tm.engine.params):
        np.testing.assert_allclose(t.detach().numpy(), jp[k], rtol=TOL,
                                   atol=TOL, err_msg=k)
