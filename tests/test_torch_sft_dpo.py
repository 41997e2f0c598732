"""The port's SFT and DPO surface against the JAX package's, on the CPU:

- the ``prompt_answer``, ``rw_pair`` and ``prompt`` datasets give equal
  ``SequenceSample``s on the ``tests/fixtures.py`` tokenizer (the prompt
  dataset's left padding side included), and ``data/preprocess.py`` writes
  equal files;
- ``ops/dpo.py`` (``dpo_pair_loss``, ``pairwise_logratios``) and
  ``sft_loss_fn`` on packed rows of several sequences with prompt masks;
- ``SFTInterface`` and ``DPOInterface``: two train steps from the same
  float32 weights (one micro-batch, then two; statistics and parameters to
  1e-4), ``evaluate``'s ``eval_nll``, the reference model's logprobs, and
  a step that does not depend on its split into 3 micro-batches;
- the ``null`` interface.
"""

import json

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
from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.train_engine import TrainEngine
from areal_tpu_torch.models.convert import params_from_jax
from tests.fixtures import dataset, dataset_path, save_path, tokenizer  # noqa: F401
from tests.test_torch_train_engine import _flat, _port_layout
from tests.test_torch_train_model import port_config

TOL = 1e-4
VOCAB = 64
OPT = dict(lr=5e-3, warmup_steps_proportion=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _to_port(js: JSample) -> SequenceSample:
    return SequenceSample(
        keys=set(js.keys), trailing_shapes=dict(js.trailing_shapes),
        dtypes=dict(js.dtypes), ids=list(js.ids),
        seqlens={k: [list(ls) for ls in v] for k, v in js.seqlens.items()},
        data={k: np.array(v, copy=True) for k, v in js.data.items()},
        metadata={k: list(v) for k, v in js.metadata.items()},
    )


def _assert_same_sample(ts, js):
    assert ts.keys == js.keys and ts.ids == js.ids
    assert ts.seqlens == js.seqlens
    assert ts.trailing_shapes == js.trailing_shapes
    assert ts.dtypes == js.dtypes
    assert ts.metadata == js.metadata
    for k in js.keys:
        assert ts.data[k].dtype == js.data[k].dtype, k
        np.testing.assert_array_equal(ts.data[k], js.data[k], err_msg=k)


# ---------------------------------------------------------------------------
# datasets and preprocessing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("prompt_answer", dict(max_length=32)),
    ("prompt_answer", dict(max_length=12, pad_to_max_length=True)),
    ("rw_pair", dict(max_length=32, max_pairs_per_prompt=2)),
    ("prompt", dict(max_length=16)),
], ids=["prompt_answer", "prompt_answer_padded", "rw_pair", "prompt"])
def test_datasets_equal_the_jax_packages(name, args, tokenizer, dataset_path):
    import areal_tpu.data  # noqa: F401
    from areal_tpu.api import dataset_api as jds
    from areal_tpu.api.config import DatasetAbstraction as JAbs
    from areal_tpu_torch.api import dataset_api as tds
    from areal_tpu_torch.api.config import DatasetAbstraction
    from areal_tpu_torch.data import register_all

    register_all()

    def make(api, abs_cls, side):
        tokenizer.padding_side = side
        return api.make_dataset(
            abs_cls(name, dict(dataset_path=dataset_path, **args)), seed=1,
            dp_rank=0, world_size=1, tokenizer_or_path=tokenizer)

    # the JAX datasets built on a right-padding tokenizer; the port's
    # prompt dataset on one too (it sets "left", as the reference's does),
    # its other datasets on a left-padding one (they never pad on a side)
    jd = make(jds, JAbs, "right")
    td = make(tds, DatasetAbstraction, "right" if name == "prompt" else "left")
    if name == "prompt":
        assert tokenizer.padding_side == "left"
    assert len(td) == len(jd) > 0
    for i in range(len(jd)):
        _assert_same_sample(td[i], jd[i])
    if name == "rw_pair":
        s = td[0]
        assert s.metadata["group_factor"] == [2 / len(s.seqlens["packed_input_ids"][0])]


def test_the_data_package_import_stays_light():
    """The verifier pool's workers import ``data.math_parser``: the
    package import loads no dataset, so no torch, until
    ``register_all``."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys\n"
            "import areal_tpu_torch.verifiers.math_verify\n"
            "assert 'torch' not in sys.modules\n"
            "from areal_tpu_torch.api import dataset_api\n"
            "from areal_tpu_torch.data import register_all\n"
            "register_all()\n"
            "assert {'math_code_prompt', 'prompt_answer', 'prompt', 'rw_pair'}"
            " <= set(dataset_api._DATASETS)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_preprocess_writes_the_jax_packages_files(tmp_path):
    from areal_tpu.data import preprocess as jpre
    from areal_tpu_torch.data import preprocess as tpre

    prompts = [{"query_id": int(i), "prompt": f"{i}*{i}?"} for i in range(6)]
    prompts.append({"prompt": "no id"})
    id2info = {str(i): {"solutions": [f"\\boxed{{{i * i}}}"]}
               for i in range(0, 6, 2)}
    code = [{"query_id": f"c{i}", "question": f"q{i}",
             "input_output": json.dumps({"inputs": [str(i)],
                                         "outputs": [str(i)]}),
             **({"timeout": 3} if i % 2 else {})} for i in range(4)]
    code.append({"query_id": "bad", "input_output": "{not json"})
    (tmp_path / "p.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in prompts))
    (tmp_path / "id2info.json").write_text(json.dumps(id2info))
    (tmp_path / "c.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in code))
    for pkg, main in (("j", jpre.main), ("t", tpre.main)):
        d = tmp_path / pkg
        d.mkdir()
        assert main(["math", "--prompts", str(tmp_path / "p.jsonl"),
                     "--id2info", str(tmp_path / "id2info.json"),
                     "--output", str(d / "math.jsonl")]) == 0
        assert main(["code", "--input", str(tmp_path / "c.jsonl"),
                     "--output", str(d / "code.jsonl"),
                     "--prompt-template", "qwen-think"]) == 0
        assert main(["merge", "--inputs", str(d / "math.jsonl"),
                     str(d / "code.jsonl"), str(d / "math.jsonl"),
                     "--output", str(d / "mixed.jsonl"), "--shuffle",
                     "--seed", "7"]) == 0
        # no valid row: no file, exit 1
        (d / "empty.jsonl").write_text("")
        assert main(["merge", "--inputs", str(d / "empty.jsonl"),
                     "--output", str(d / "none.jsonl")]) == 1
    for f in ("math.jsonl", "code.jsonl", "mixed.jsonl"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    assert not (tmp_path / "t" / "none.jsonl").exists()


def test_preprocess_runs_as_a_module(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    (tmp_path / "a.jsonl").write_text(json.dumps({"task": "math", "query_id": "1"}) + "\n")
    out = subprocess.run(
        [sys.executable, "-m", "areal_tpu_torch.data.preprocess", "merge",
         "--inputs", str(tmp_path / "a.jsonl"), str(tmp_path / "a.jsonl"),
         "--output", str(tmp_path / "m.jsonl")],
        cwd=repo, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "m.jsonl").read_text().count("\n") == 1


# ---------------------------------------------------------------------------
# ops/dpo.py and sft_loss_fn
# ---------------------------------------------------------------------------


def test_dpo_ops_equal_the_jax_packages():
    from areal_tpu.ops import dpo as jdpo
    from areal_tpu_torch.ops import dpo as tdpo

    rng = np.random.default_rng(0)
    P, B, T, beta = 8, 3, 20, 0.3
    pi = rng.standard_normal(P).astype(np.float32)
    ref = rng.standard_normal(P).astype(np.float32)
    valid = rng.random(P) > 0.3
    jl, jn, js = jdpo.dpo_pair_loss(jnp.asarray(pi), jnp.asarray(ref),
                                    jnp.asarray(valid), beta)
    tl, tn, ts = tdpo.dpo_pair_loss(torch.from_numpy(pi), torch.from_numpy(ref),
                                    torch.from_numpy(valid), beta)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tn) == float(jn)
    for k in js:
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    vals = rng.standard_normal((B, T)).astype(np.float32)
    sign = np.where(rng.random((B, T)) > 0.5, 1, -1).astype(np.float32)
    pair = rng.integers(0, P, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.2).astype(np.float32)
    j = jdpo.pairwise_logratios(*map(jnp.asarray, (vals, sign, pair, mask)), P)
    t = tdpo.pairwise_logratios(*map(torch.from_numpy, (vals, sign, pair, mask)), P)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def _packed_batch(seed=0, B=3, T=24, vocab=VOCAB):
    """Rows that pack several sequences (seg ids 1..k, positions from 0 in
    each), padding at the row ends, and random prompt masks that start
    each sequence."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (B, T)).astype(np.int32)
    seg = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    pmask = np.zeros((B, T), bool)
    for b in range(B):
        col, s = 0, 1
        while col < T - 3:
            L = int(rng.integers(3, 10))
            L = min(L, T - 2 - col) if b == 0 else min(L, T - col)
            seg[b, col:col + L] = s
            pos[b, col:col + L] = np.arange(L)
            pmask[b, col:col + int(rng.integers(1, L))] = True
            col += L
            s += 1
    return dict(tokens=tokens, positions=pos, seg_ids=seg, prompt_mask=pmask)


def test_sft_loss_fn_on_packed_rows_equals_the_jax_packages():
    from areal_tpu.interfaces import sft_interface as jsft
    from areal_tpu_torch.interfaces import sft_interface as tsft

    jcfg = jtiny(vocab_size=VOCAB)
    cfg = port_config(jcfg)
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(1)))
    params = params_from_jax(tree, cfg, "cpu")
    for seed in range(2):
        batch = _packed_batch(seed)
        jl, jc, jst = jsft.sft_loss_fn(
            tree, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, tc, tst = tsft.sft_loss_fn(
            params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tc) == float(jc) > 0
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
        np.testing.assert_allclose(float(tst["nll_sum"]), float(jst["nll_sum"]),
                                   rtol=TOL)
        # the step from one packed sequence into the next never counts
        seg = batch["seg_ids"]
        cross = (seg[:, 1:] != seg[:, :-1]) & (seg[:, 1:] != 0) & (seg[:, :-1] != 0)
        assert cross.any()
        no_prompt = {k: torch.from_numpy(v) for k, v in batch.items()
                     if k != "prompt_mask"}
        _, c_all, _ = tsft.sft_loss_fn(params, cfg, no_prompt)
        same = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] != 0)
        assert float(c_all) == same.sum()


# ---------------------------------------------------------------------------
# SFTInterface and DPOInterface
# ---------------------------------------------------------------------------


def _models(seed=0, with_opt=True):
    jcfg = jtiny(vocab_size=VOCAB)
    cfg = port_config(jcfg)
    mesh = MeshSpec(data=1, fsdp=1, model=1).make_mesh(jax.devices()[:1])
    tree = jax.device_get(jt.init_params(jcfg, jax.random.PRNGKey(seed)))
    je = JEngine(jcfg, mesh, jax.tree.map(jnp.asarray, tree),
                 JOptCfg(**OPT) if with_opt else None, 100)
    te = TrainEngine(cfg, None, params_from_jax(tree, cfg, "cpu"),
                     OptimizerConfig(**OPT) if with_opt else None, 100,
                     device="cpu")
    return (jmodel_api.Model("actor", je, None, mesh,
                             ft_spec=jmodel_api.FinetuneSpec(1, 100, 10)),
            model_api.Model("actor", te,
                            ft_spec=model_api.FinetuneSpec(1, 100, 10)),
            cfg)


def _sft_sample(n=6, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 14, n)
    toks = rng.integers(1, VOCAB, int(lens.sum())).astype(np.int32)
    pmask = np.concatenate(
        [np.arange(L) < int(rng.integers(1, L - 1)) for L in lens])
    js = JSample.from_default(
        seqlens=[int(l) for l in lens], ids=[f"s{i}" for i in range(n)],
        data={"packed_input_ids": toks, "prompt_mask": pmask})
    return js, _to_port(js)


def _assert_same_params(jm, tm, cfg):
    jp = dict(_flat(_port_layout(jax.device_get(jm.engine.params), cfg.n_layers)))
    for k, t in _flat(tm.engine.params):
        np.testing.assert_allclose(t.detach().numpy(), jp[k], rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_sft_train_steps_and_eval_equal_the_jax_packages():
    from areal_tpu.interfaces.sft_interface import SFTInterface as JSFT
    from areal_tpu_torch.interfaces.sft_interface import SFTInterface

    jm, tm, cfg = _models(seed=2)
    ji, ti = JSFT(), SFTInterface()
    for step, n_mbs in enumerate((1, 2)):
        js, ts = _sft_sample(seed=5 + step)
        jst = ji.train_step(jm, js, JSpec(n_mbs=n_mbs))
        tst = ti.train_step(tm, ts, MicroBatchSpec(n_mbs=n_mbs))
        assert tst["n_tokens"] == jst["n_tokens"] > 0
        for k in ("loss", "grad_norm", "nll_sum", "n_valid_tokens"):
            np.testing.assert_allclose(tst[k], jst[k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}: {k}")
        assert tm.version.global_step == jm.version.global_step == step + 1
    _assert_same_params(jm, tm, cfg)
    evals = [_sft_sample(n=3, seed=s) for s in (11, 12)]
    je = ji.evaluate(jm, [j for j, _ in evals])
    te = ti.evaluate(tm, [t for _, t in evals])
    assert te["eval_tokens"] == je["eval_tokens"] > 0
    np.testing.assert_allclose(te["eval_nll"], je["eval_nll"], rtol=TOL)


def test_sft_step_is_split_invariant_at_three_micro_batches():
    """The loss has no floored count, so a 3-way split (the JAX engine
    pads it to 4 all-zero micro-batches) gives the one-batch step."""
    from areal_tpu.interfaces.sft_interface import SFTInterface as JSFT
    from areal_tpu_torch.interfaces.sft_interface import SFTInterface

    js, ts = _sft_sample(n=6, seed=21)
    _, t1, cfg = _models(seed=4)
    s1 = SFTInterface().train_step(t1, ts, MicroBatchSpec(n_mbs=1))
    jm, t3, _ = _models(seed=4)
    s3 = SFTInterface().train_step(t3, _to_port(js), MicroBatchSpec(n_mbs=3))
    j3 = JSFT().train_step(jm, js, JSpec(n_mbs=3))
    assert s3["n_mbs"] == 3
    np.testing.assert_allclose(s3["loss"], s1["loss"], rtol=1e-5)
    np.testing.assert_allclose(s3["loss"], j3["loss"], rtol=TOL)
    for (k, a), (_, b) in zip(_flat(t1.engine.params), _flat(t3.engine.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, err_msg=k)
    _assert_same_params(jm, t3, cfg)


def _paired_sample(n_prompts=4, seed=0):
    """[chosen, rejected] per id over a shared prompt, with prompt masks."""
    rng = np.random.default_rng(seed)
    groups, parts, masks = [], [], []
    for _ in range(n_prompts):
        prompt = rng.integers(1, VOCAB, int(rng.integers(2, 5)))
        pair = [np.concatenate([prompt, rng.integers(1, VOCAB, int(rng.integers(3, 8)))])
                for _ in range(2)]
        groups.append([len(s) for s in pair])
        parts += pair
        masks += [np.arange(len(s)) < len(prompt) for s in pair]
    lens = groups
    js = JSample(
        keys={"packed_input_ids", "prompt_mask"},
        trailing_shapes={"packed_input_ids": (), "prompt_mask": ()},
        dtypes={"packed_input_ids": np.dtype(np.int32),
                "prompt_mask": np.dtype(bool)},
        ids=[f"q{i}" for i in range(n_prompts)],
        seqlens={"packed_input_ids": lens, "prompt_mask": lens},
        data={"packed_input_ids": np.concatenate(parts).astype(np.int32),
              "prompt_mask": np.concatenate(masks)})
    return js, _to_port(js)


def test_dpo_ref_logprobs_and_train_steps_equal_the_jax_packages():
    from areal_tpu.interfaces.dpo_interface import DPOInterface as JDPO
    from areal_tpu_torch.interfaces.dpo_interface import DPOInterface

    jref, tref, _ = _models(seed=1, with_opt=False)
    jm, tm, cfg = _models(seed=3)
    ji, ti = JDPO(beta=0.25), DPOInterface(beta=0.25)
    for step, n_mbs in enumerate((1, 2)):
        js, ts = _paired_sample(n_prompts=4, seed=7 + step)
        jr = ji.inference(jref, js, JSpec())
        tr = ti.inference(tref, ts, MicroBatchSpec())
        assert tr.keys == {"packed_ref_logprobs"} and tr.seqlens == jr.seqlens
        np.testing.assert_allclose(tr.data["packed_ref_logprobs"],
                                   jr.data["packed_ref_logprobs"], rtol=TOL,
                                   atol=TOL)
        js.update_(jr)
        ts.update_(tr)
        jst = ji.train_step(jm, js, JSpec(n_mbs=n_mbs))
        tst = ti.train_step(tm, ts, MicroBatchSpec(n_mbs=n_mbs))
        assert tst["n_tokens"] == jst["n_tokens"] == 4.0  # pairs
        for k in ("loss", "grad_norm", "margin_sum", "reward_acc_sum"):
            np.testing.assert_allclose(tst[k], jst[k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step}: {k}")
        assert tm.version.global_step == jm.version.global_step == step + 1
    _assert_same_params(jm, tm, cfg)


def test_dpo_step_is_split_invariant_at_three_micro_batches():
    from areal_tpu.interfaces.dpo_interface import DPOInterface as JDPO
    from areal_tpu_torch.interfaces.dpo_interface import DPOInterface

    js, ts = _paired_sample(n_prompts=6, seed=2)
    _, tref, _ = _models(seed=4, with_opt=False)
    ts.update_(DPOInterface().inference(tref, ts, MicroBatchSpec()))
    js.update_(_ref_as_jax(ts, js))
    _, t1, _ = _models(seed=3)
    s1 = DPOInterface(beta=0.25).train_step(t1, _copy(ts), MicroBatchSpec(n_mbs=1))
    jm, t3, cfg = _models(seed=3)
    s3 = DPOInterface(beta=0.25).train_step(t3, _copy(ts), MicroBatchSpec(n_mbs=3))
    j3 = JDPO(beta=0.25).train_step(jm, js, JSpec(n_mbs=3))
    assert s3["n_mbs"] == 3 and s3["n_tokens"] == s1["n_tokens"] == 6.0
    np.testing.assert_allclose(s3["loss"], s1["loss"], rtol=1e-5)
    np.testing.assert_allclose(s3["loss"], j3["loss"], rtol=TOL)
    for (k, a), (_, b) in zip(_flat(t1.engine.params), _flat(t3.engine.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, err_msg=k)
    _assert_same_params(jm, t3, cfg)


def _copy(ts):
    return SequenceSample(
        keys=set(ts.keys), trailing_shapes=dict(ts.trailing_shapes),
        dtypes=dict(ts.dtypes), ids=list(ts.ids),
        seqlens={k: [list(ls) for ls in v] for k, v in ts.seqlens.items()},
        data={k: np.array(v, copy=True) for k, v in ts.data.items()})


def _ref_as_jax(ts, js):
    k = "packed_ref_logprobs"
    return JSample(keys={k}, trailing_shapes={k: ()},
                   dtypes={k: np.dtype(np.float32)}, ids=list(js.ids),
                   seqlens={k: [list(ls) for ls in ts.seqlens[k]]},
                   data={k: np.array(ts.data[k], copy=True)})


def test_dpo_loss_starts_at_ln2_when_the_actor_is_its_reference():
    from areal_tpu_torch.interfaces.dpo_interface import DPOInterface

    _, ref, _ = _models(seed=5, with_opt=False)
    _, actor, _ = _models(seed=5)
    _, ts = _paired_sample(n_prompts=4, seed=3)
    iface = DPOInterface(beta=0.1)
    ts.update_(iface.inference(ref, ts, MicroBatchSpec()))
    first = iface.train_step(actor, ts, MicroBatchSpec())
    assert abs(first["loss"] - np.log(2.0)) < 1e-5
    for _ in range(10):
        stats = iface.train_step(actor, ts, MicroBatchSpec())
    assert stats["loss"] < first["loss"]


def test_null_interface_equals_the_jax_packages():
    from areal_tpu.interfaces.null_interface import NullInterface as JNull
    from areal_tpu_torch.interfaces.null_interface import NullInterface

    js, ts = _sft_sample(n=5, seed=1)
    jr = JNull().inference(None, js, JSpec())
    tr = NullInterface().inference(None, ts, MicroBatchSpec())
    _assert_same_sample(tr, jr)
    assert NullInterface().train_step(None, ts, MicroBatchSpec()) == \
        JNull().train_step(None, js, JSpec())
    assert NullInterface().generate(None, ts, MicroBatchSpec()) is None
