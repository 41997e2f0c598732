"""The torch port's paged forwards (``paged_fill_chunk``,
``paged_decode_chunk``) against the JAX package's, on the same pool, block
tables, weights and tokens, in float32.  On the CPU the JAX functions take
their jnp reference attention (``use_kernel=False``, as the engine does off
TPU) and the port takes its kernel's plain version.  Tolerance 1e-4
(forward, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from areal_tpu.engine.sampling import SamplingParams as JaxSampling
from areal_tpu.engine.sampling import sample_logits_keyed as jax_sample
from areal_tpu.models import paged as jpaged
from areal_tpu.models import transformer as jt
from areal_tpu_torch.engine.sampling import SamplingParams, sample_logits_keyed
from areal_tpu_torch.models import paged as tpaged
from areal_tpu_torch.models.convert import params_from_jax
from tests.test_torch_model import port_config

TOL = 1e-4
BS, MB, NB = 8, 8, 20
EOS = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_greedy(logits, _rng, positions, seeds):
    return jax_sample(logits, jax.random.PRNGKey(0), seeds, positions,
                      JaxSampling(greedy=True))


def _jax_stop(tok):
    return tok == EOS


def _port_greedy(logits, positions, seeds):
    return sample_logits_keyed(logits, 0, seeds, positions,
                               SamplingParams(greedy=True))


def _port_stop(tok):
    return tok == EOS


class Pair:
    """The same model and pool state on both sides."""

    def __init__(self, seed=0):
        self.jcfg = __graft_entry__._flagship_tiny()
        self.cfg = port_config(self.jcfg)
        tree = jax.device_get(jt.init_params(self.jcfg, jax.random.PRNGKey(seed)))
        self.jparams = jax.tree.map(jnp.asarray, tree)
        self.params = params_from_jax(tree, self.cfg, "cpu")
        rng = np.random.default_rng(seed)
        shape = (self.cfg.n_layers, NB, self.cfg.n_kv_heads, BS,
                 self.cfg.head_dim)
        # stale garbage everywhere: only masked reads/writes keep it out
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        self.jk, self.jv = jnp.asarray(k), jnp.asarray(v)
        self.tk, self.tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        perm = rng.permutation(NB)
        # rows 0 and 1 own scrambled blocks; row 2's table is all zeros
        # (a released row): block 0 belongs to another row
        self.tables = np.zeros((3, MB), np.int32)
        self.tables[0] = perm[:MB]
        self.tables[1] = perm[MB: 2 * MB]

    def fill(self, rows, toks, starts, lens):
        C = max(len(t) for t in toks)
        tk = np.zeros((len(rows), C), np.int32)
        for i, t in enumerate(toks):
            tk[i, : len(t)] = t
        tables = self.tables[rows]
        args = (tk, np.asarray(starts, np.int32), np.asarray(lens, np.int32),
                tables)
        jl, self.jk, self.jv = jpaged.paged_fill_chunk(
            self.jparams, self.jk, self.jv, self.jcfg,
            *(jnp.asarray(a) for a in args), use_kernel=False,
        )
        tl = tpaged.paged_fill_chunk(
            self.params, self.tk, self.tv, self.cfg,
            *(torch.from_numpy(a) for a in args),
        )
        return np.asarray(jl), tl.numpy()

    def decode(self, lengths, cur, active, budgets, chunk=4, max_len=MB * BS):
        seeds = np.arange(len(lengths), dtype=np.int32) + 11
        args = (self.tables, np.asarray(lengths, np.int32),
                np.asarray(cur, np.int32), np.asarray(active, bool),
                np.asarray(budgets, np.int32))
        out = jpaged.paged_decode_chunk(
            self.jparams, self.jk, self.jv, self.jcfg,
            *(jnp.asarray(a) for a in args), jax.random.PRNGKey(1), chunk,
            _jax_greedy, _jax_stop, use_kernel=False, max_len=max_len,
            row_seeds=jnp.asarray(seeds),
        )
        self.jk, self.jv = out[0], out[1]
        jres = [np.asarray(x) for x in out[2:9]]
        tres = tpaged.paged_decode_chunk(
            self.params, self.tk, self.tv, self.cfg,
            *(torch.from_numpy(a.copy()) for a in args), chunk,
            _port_greedy, _port_stop, max_len, torch.from_numpy(seeds),
        )
        return jres, [x.numpy() for x in tres]

    def check_pools(self):
        np.testing.assert_allclose(self.tk.numpy(), np.asarray(self.jk),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(self.tv.numpy(), np.asarray(self.jv),
                                   rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def filled():
    """Rows 0 (29 tokens) and 1 (17 tokens) prefilled in 12-token chunks:
    prompts split across chunks and pages, unequal lengths, and a last
    chunk in which row 1 has no tokens."""
    pair = Pair()
    rng = np.random.default_rng(1)
    p0 = rng.integers(0, pair.cfg.vocab_size, 29).tolist()
    p1 = rng.integers(0, pair.cfg.vocab_size, 17).tolist()
    steps = [
        ([p0[0:12], p1[0:12]], [0, 0], [12, 12]),
        ([p0[12:24], p1[12:17]], [12, 12], [12, 5]),
        ([p0[24:29], []], [24, 17], [5, 0]),
    ]
    logits = []
    for toks, starts, lens in steps:
        jl, tl = pair.fill([0, 1], toks, starts, lens)
        logits.append((jl, tl, lens))
        pair.check_pools()
    return pair, logits


def test_fill_chunks_match(filled):
    pair, logits = filled
    for jl, tl, lens in logits:
        live = np.asarray(lens) > 0
        np.testing.assert_allclose(tl[live], jl[live], rtol=TOL, atol=TOL)
    # each row's final logits come from its last chunk
    assert np.argmax(logits[2][1][0]) == np.argmax(logits[2][0][0])
    assert np.argmax(logits[1][1][1]) == np.argmax(logits[1][0][1])


def test_decode_chunks_match(filled):
    pair, logits = filled
    cur = [int(np.argmax(logits[2][0][0])), int(np.argmax(logits[1][0][1])), 3]
    lengths, active, budgets = [29, 17, 5], [True, True, False], [7, 2, 9]
    for _ in range(2):  # the second chunk reads the first one's merge
        jres, tres = pair.decode(lengths, cur, active, budgets)
        names = ("lengths", "out_t", "out_l", "emitted", "cur", "active",
                 "budgets")
        for name, j, t in zip(names, jres, tres):
            if name == "out_l":
                np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
            else:
                np.testing.assert_array_equal(t, j, err_msg=name)
        pair.check_pools()
        lengths, _, _, _, cur, active, budgets = (r.tolist() for r in jres)
    # row 1 stopped on its budget inside the first chunk; row 2 never ran
    assert not active[1] and not active[2]


def test_scatter_drops_every_invalid_entry():
    pool = torch.randn(2, 4, 1, 3, 2)
    before = pool.clone()
    pid = torch.tensor([[1, 0], [0, 2]])
    off = torch.tensor([[2, 1], [0, 0]])
    vals = torch.randn(2, 2, 2, 1, 2)  # [entries..., L, Hkv, hd]
    tpaged._scatter_slots_(pool, pid, off, vals, torch.zeros(2, 2, dtype=torch.bool))
    assert torch.equal(pool, before)  # nothing valid: nothing changes
    valid = torch.tensor([[False, True], [False, True]])
    tpaged._scatter_slots_(pool, pid, off, vals, valid)
    want = before.clone()
    want[:, 0, :, 1] = vals[0, 1]
    want[:, 2, :, 0] = vals[1, 1]
    assert torch.equal(pool, want)
