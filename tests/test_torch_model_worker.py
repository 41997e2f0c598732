"""The port's ``ModelWorker`` against the JAX package's: both packages'
worker handlers driven with the same ``SequenceSample`` batch and the same
weights (the JAX init, converted to the port's tree): ``initialize``,
actor_inf (``inference``) and then two actor_train steps (``train_step``)
through ``_handle_model_rpc``, with the async-PPO recipe's actor flags.

* ``prox_logp``, the returned statistics and every trained parameter agree
  to 1e-4 (float32 on both sides).
* The published snapshot's manifest names the same leaves, shapes and
  dtypes as the JAX worker's (the port keeps layers as a list, so its
  ``layers/<i>/...`` leaves stack into the JAX package's ``layers/...``),
  and so does the int8 sibling's advertisement.
* ``quantize_param_tree`` agrees with the JAX package's: int8 values
  exact, scales to 1e-6.
* ``save_train_state`` and ``load_train_state`` round-trip the trainer's
  state bit for bit.

The workers are built without their ``_configure`` (which would wait for a
master's stream): each gets the attributes its handlers read and its own
data manager on its package's in-memory name_resolve.
"""

import json
import logging
import os
import threading

import jax
import numpy as np
import pytest
import torch

from areal_tpu.api import config as jconfig
from areal_tpu.api import model_api as jmodel_api
from areal_tpu.api import system_api as jsystem_api
from areal_tpu.api.data import MicroBatchSpec as JSpec
from areal_tpu.base import constants as jconstants
from areal_tpu.base import name_resolve as jname_resolve
from areal_tpu.engine.optimizer import OptimizerConfig as JOptCfg
from areal_tpu.models import quantize as jquantize
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.system import model_worker as jmw
from areal_tpu.system.data_manager import DataManager as JDataManager
from areal_tpu.system.request_reply_stream import Payload as JPayload
from areal_tpu_torch.api import config as tconfig
from areal_tpu_torch.api import model_api as tmodel_api
from areal_tpu_torch.api import system_api as tsystem_api
from areal_tpu_torch.api.data import MicroBatchSpec
from areal_tpu_torch.base import constants as tconstants
from areal_tpu_torch.base import name_resolve as tname_resolve
from areal_tpu_torch.engine import backend as tbackend
from areal_tpu_torch.engine import checkpoint as tck
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.train_engine import TrainEngine, tree_leaves
from areal_tpu_torch.models import quantize as tquantize
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.system import model_worker as tmw
from areal_tpu_torch.system.data_manager import DataManager as TDataManager
from areal_tpu_torch.system.request_reply_stream import Payload as TPayload
from tests.test_torch_ppo_actor import OPT, RECIPE, rollout
from tests.test_torch_train_engine import _flat, _port_layout
from tests.test_torch_train_model import port_config, randomized_tree

TOL = 1e-4
MODEL = "actor@0"
STATS = ("loss", "grad_norm", "actor_clip_frac", "approx_kl", "entropy",
         "adv_sum", "n_tokens", "n_mbs", "kl", "reward_mean")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _worker(pkg, trial):
    """A ModelWorker of ``pkg`` ("jax" or "torch") with the attributes its
    handlers read, its data manager on a fresh in-memory name_resolve."""
    if pkg == "jax":
        mw, system_api, config, nr, consts, DM = (
            jmw, jsystem_api, jconfig, jname_resolve, jconstants, JDataManager)
        opt, extra = JOptCfg(**OPT), {}
    else:
        mw, system_api, config, nr, consts, DM = (
            tmw, tsystem_api, tconfig, tname_resolve, tconstants, TDataManager)
        opt, extra = OptimizerConfig(**OPT), {"device": "cpu"}
    nr.reconfigure("memory")
    consts.set_experiment_trial_names("test-mw", trial)
    iface = config.ModelInterfaceAbstraction
    w = mw.ModelWorker.__new__(mw.ModelWorker)
    w.config = system_api.ModelWorkerConfig(
        worker_name="model-worker-0",
        interfaces={
            "actor_inf": iface("ppo_actor", {**RECIPE}),
            "actor_train": iface("ppo_actor", {**RECIPE}),
        },
        **extra,
    )
    w.worker_name = w.config.worker_name
    w.logger = logging.getLogger(f"test-mw-{pkg}")
    w._models, w._backends, w._interfaces = {}, {}, {}
    w._tokenizer = None
    w._publish_lock = threading.Lock()
    w._publish_threads = []
    w._last_published_version = {}
    w._tracer = None
    w._cuda_stream = None
    w._data_manager = DM("test-mw", trial, w.worker_name)
    shard = system_api.ModelShard(
        model_name=config.ModelName("actor"),
        model=config.ModelAbstraction("random", {"seed": 1}),
        backend=config.ModelBackendAbstraction("train", {"optimizer": opt}),
    )
    return w, shard


def _rpc(w, payload_cls, handle, rpc, ids, keys):
    return w._handle_model_rpc(payload_cls(
        handler=w.worker_name, handle_name=handle,
        data=dict(rpc_name=rpc, model_name=MODEL, handle_name=handle,
                  ids=ids, input_keys=keys,
                  mb_spec=(JSpec if payload_cls is JPayload
                           else MicroBatchSpec)(max_tokens_per_mb=24))))


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Both workers after initialize, actor_inf and two actor_train steps on
    the same rollout, and both after publishing the trained weights."""
    import areal_tpu.engine.backend  # noqa: F401 - registers the backends
    import areal_tpu.interfaces.ppo_interface  # noqa: F401
    import areal_tpu_torch.interfaces.ppo_interface  # noqa: F401

    root = tmp_path_factory.mktemp("publish")
    old_root = os.environ.get("AREAL_SAVE_ROOT")
    os.environ["AREAL_SAVE_ROOT"] = str(root)
    jcfg = jtiny(vocab_size=64, remat=True)
    cfg = port_config(jcfg)
    ft = dict(total_train_epochs=1, dataset_size=8, train_batch_size=8)
    out = {"cfg": cfg}
    try:
        jw, jshard = _worker("jax", "jax")
        jshard.model.args["config"] = jcfg
        jw._handle_initialize(jshard, jmodel_api.FinetuneSpec(**ft))
        tree = jax.device_get(jw._models[MODEL].engine.params)

        orig = tbackend.make_model

        def converted(*args, **kw):
            model = orig(*args, **kw)
            model.init_params = params_from_jax(tree, cfg, "cpu")
            return model

        tbackend.make_model = converted
        try:
            tw, tshard = _worker("torch", "torch")
            tshard.model.args["config"] = cfg
            tw._handle_initialize(tshard, tmodel_api.FinetuneSpec(**ft))
        finally:
            tbackend.make_model = orig

        js, ts = rollout(cfg.vocab_size)
        ids = list(ts.ids)
        jw._data_manager.store(js)
        tw._data_manager.store(ts)
        infer_keys = ["packed_input_ids", "prompt_mask"]
        train_keys = infer_keys + ["packed_logprobs", "rewards",
                                   "seq_no_eos_mask", "prox_logp"]
        for w, p in ((jw, JPayload), (tw, TPayload)):
            _rpc(w, p, "inference", "actor_inf", ids, infer_keys)
        out["prox"] = [np.asarray(w._data_manager.get_batch(
            ids, ["prox_logp"]).data["prox_logp"]) for w in (jw, tw)]
        out["stats"] = [
            [_rpc(w, p, "train_step", "actor_train", ids, train_keys)["stats"]
             for _ in range(2)]
            for w, p in ((jw, JPayload), (tw, TPayload))
        ]
        for w in (jw, tw):
            w._publish_weights(MODEL)
            for t in w._publish_threads:
                t.join(120)
        out["manifests"] = []
        for trial in ("jax", "torch"):
            base = os.path.join(str(root), os.listdir(str(root))[0],
                                "test-mw", trial, "param_realloc", "actor")
            with open(os.path.join(base, "v2", tck.MANIFEST_NAME)) as f:
                out["manifests"].append(json.load(f))
            out.setdefault("int8_dirs", []).append(
                sorted(os.listdir(base)))
        out["jax"], out["torch"] = jw, tw
        yield out
    finally:
        if old_root is None:
            os.environ.pop("AREAL_SAVE_ROOT", None)
        else:
            os.environ["AREAL_SAVE_ROOT"] = old_root
        for w in (out.get("jax"), out.get("torch")):
            if w is not None:
                w._data_manager.close()


def test_actor_inf_then_two_train_steps_match_the_jax_worker(workers):
    jprox, tprox = workers["prox"]
    np.testing.assert_allclose(tprox, jprox, rtol=TOL, atol=TOL)
    jstats, tstats = workers["stats"]
    for step, (js, ts) in enumerate(zip(jstats, tstats)):
        for k in STATS:
            np.testing.assert_allclose(ts[k], js[k], rtol=TOL, atol=TOL,
                                       err_msg=f"step {step + 1}: {k}")
    jm, tm = (workers[p]._models[MODEL] for p in ("jax", "torch"))
    assert jm.version.global_step == tm.version.global_step == 2
    cfg = workers["cfg"]
    jp = dict(_flat(_port_layout(jax.device_get(jm.engine.params),
                                 cfg.n_layers)))
    for k, t in _flat(tm.engine.params):
        np.testing.assert_allclose(t.detach().numpy(), jp[k], rtol=TOL,
                                   atol=TOL, err_msg=k)


def _stacked(leaves):
    """A port manifest's leaves with ``layers/<i>/...`` stacked into the JAX
    package's ``layers/...`` (shape ``[n_layers] + shape``)."""
    out, per_layer = {}, {}
    for k, v in leaves.items():
        parts = k.split("/")
        if parts[0] == "layers":
            key = "/".join(["layers"] + parts[2:])
            per_layer.setdefault(key, []).append((int(parts[1]), v))
        else:
            out[k] = v
    for key, vs in per_layer.items():
        vs.sort(key=lambda x: x[0])
        assert [i for i, _ in vs] == list(range(len(vs)))
        assert all(v == vs[0][1] for _, v in vs), key
        out[key] = dict(vs[0][1], shape=[len(vs)] + vs[0][1]["shape"])
    return out


def test_published_manifest_names_the_jax_workers_leaves(workers):
    jman, tman = workers["manifests"]
    assert tman["version"] == jman["version"] == 2
    assert _stacked(tman["leaves"]) == jman["leaves"]
    jq, tq = (m["serving_quant"]["int8"] for m in (jman, tman))
    assert tq["dir"] == jq["dir"] == "v2-int8"
    assert _stacked(tq["leaves"]) == jq["leaves"]
    for dirs in workers["int8_dirs"]:
        assert {"v2", "v2-int8"} <= set(dirs)


def test_quantize_param_tree_matches_the_jax_package():
    jcfg = jtiny(vocab_size=64, tied_embedding=False)
    cfg = port_config(jcfg)
    tree = randomized_tree(jcfg, 5)
    jq = jax.device_get(jquantize.quantize_param_tree(
        jax.tree.map(np.asarray, tree)))
    tq = tquantize.quantize_param_tree(params_from_jax(tree, cfg, "cpu"))
    jflat = dict(_flat(_port_layout(jq, cfg.n_layers)))
    tflat = dict(_flat(tq))
    assert set(tflat) == set(jflat)
    n_q = 0
    for k, t in tflat.items():
        got = t.detach().numpy()
        if k.endswith("/qw"):
            n_q += 1
            assert got.dtype == np.int8
            np.testing.assert_array_equal(got, jflat[k], err_msg=k)
        elif k.endswith("/scale") and "norm" not in k:
            np.testing.assert_allclose(got, jflat[k], rtol=1e-6, atol=0,
                                       err_msg=k)
    assert n_q == tquantize.quantized_leaf_count(tq) == 7 * cfg.n_layers + 1
    assert tquantize.tree_bytes(tq) < tquantize.tree_bytes(
        params_from_jax(tree, cfg, "cpu"))


def test_train_state_round_trips_bit_for_bit(workers, tmp_path):
    engine = workers["torch"]._models[MODEL].engine
    # one AdamW update per minibatch: 4 in each of the two steps
    assert engine.opt.count == 2 * RECIPE["n_minibatches"]
    assert engine.version == engine.opt.count
    tck.save_train_state(engine, str(tmp_path / "state"))
    cfg = workers["cfg"]
    from areal_tpu_torch.models.transformer import init_params

    fresh = TrainEngine(cfg, None, init_params(cfg, 7, "cpu",
                                               dtype=torch.float32),
                        OptimizerConfig(**OPT), 10, device="cpu")
    assert not tck.load_train_state(fresh, str(tmp_path / "absent"))
    assert tck.load_train_state(fresh, str(tmp_path / "state"))
    assert fresh.version == engine.version and fresh.opt.count == engine.opt.count
    # the two engines keep their leaves in other orders (the init's and the
    # conversion's): compare by key path
    got = dict(tck._flatten(tck._state_tree(fresh)))
    want = dict(tck._flatten(tck._state_tree(engine)))
    assert set(got) == set(want) and len(want) == 3 * len(
        tree_leaves(engine.params))
    for k, b in want.items():
        assert got[k].dtype == b.dtype and torch.equal(got[k], b), k
    assert tck.latest_train_state(str(tmp_path)) is None
    os.rename(tmp_path / "state", tmp_path / "globalstep2")
    (tmp_path / "globalstep10").mkdir()
    assert tck.latest_train_state(str(tmp_path)).endswith("globalstep10")
    assert tck.latest_train_state(str(tmp_path), max_step=5).endswith(
        "globalstep2")
