"""The torch port stands alone: none of its modules (nor chip_smoke.py)
imports JAX or anything of ``areal_tpu``; its entry points run on CUDA
unless the caller asks for the CPU, and raise when CUDA is absent; its
kernel wrapper never falls back on a non-CPU tensor; and what the slice
leaves out is refused, not ignored."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from areal_tpu_torch.engine.inference_server import ContinuousBatchingEngine
from areal_tpu_torch.engine.train_engine import TrainEngine
from areal_tpu_torch.models.config import tiny_config
from areal_tpu_torch.models.convert import params_from_jax
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops import paged_attention as tpa

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_no_jax_and_no_reference_package_imported():
    code = (
        "import importlib, pkgutil, sys\n"
        "import areal_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "areal_tpu_torch.__path__, 'areal_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith(('jax.', 'jaxlib', 'areal_tpu.')) or k == 'areal_tpu')\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 12, mods\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr


def _tiny_engine_args():
    cfg = tiny_config(vocab_size=32)
    return cfg, init_params(cfg, 0, torch.device("cpu"))


def test_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = _tiny_engine_args()
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(cfg, params, kv_cache_len=64,
                                 cache_mode="paged", page_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, cfg)
    master = init_params(cfg, 0, torch.device("cpu"), dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainEngine(cfg, None, master)
    assert TrainEngine(cfg, None, master, device="cpu").device.type == "cpu"
    # an explicit CPU request is honoured
    eng = ContinuousBatchingEngine(cfg, params, kv_cache_len=64,
                                   cache_mode="paged", page_size=16,
                                   device="cpu")
    assert eng.k_pool.device.type == "cpu"


def test_kernel_wrapper_never_falls_back(monkeypatch):
    B, Q, Hq, Hkv, hd, NB, BS, MB = 2, 1, 4, 2, 128, 4, 16, 2
    meta = dict(device="meta")
    args = (
        torch.empty((B, Q, Hq, hd), **meta),
        torch.empty((NB, Hkv, BS, hd), **meta),
        torch.empty((NB, Hkv, BS, hd), **meta),
        torch.empty((B, MB), dtype=torch.int32, **meta),
        torch.empty((B,), dtype=torch.int32, **meta),
    )
    # a tensor off the CPU goes to the kernel path, which refuses it
    with pytest.raises(RuntimeError, match="CUDA"):
        tpa.paged_flash_attention(*args)
    assert tpa.paged_flash_attention.launches == 0
    # the kernel library refuses to build or load without a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="CUDA device"):
        _build.load_library("paged_attention")


def test_kernel_source_targets_hopper():
    src = (REPO / "areal_tpu_torch/csrc/paged_attention.cu").read_text()
    assert "paged_attention_fwd" in src
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize(
    "kw",
    [
        dict(prefix_cache=True),
        dict(kv_cache_dtype="int8"),
        dict(serving_weight_dtype="int8"),
        dict(spec_decode_params=object()),
        dict(slo_tracking=True),
        dict(handoff_streaming=True),
        dict(mesh=object()),
        dict(cache_mode="dense"),
        dict(kv_pool_tokens=64),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_out_of_slice_options_are_refused(kw):
    cfg, params = _tiny_engine_args()
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(
            cfg, params, max_batch=2, kv_cache_len=128, page_size=16,
            device="cpu", **dict(dict(cache_mode="paged"), **kw),
        )


def test_moe_config_is_refused():
    with pytest.raises(NotImplementedError):
        tiny_config(n_experts=4)
