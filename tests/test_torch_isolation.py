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
from areal_tpu_torch.ops import decode_attention as tda
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


def test_new_kernel_wrappers_never_fall_back():
    """The deep paged kernel, the int8 branch and flash_decode: a tensor
    off the CPU goes to the kernel path, which refuses it here."""
    B, Q, Hq, Hkv, hd, NB, BS, MB = 2, 1, 4, 2, 128, 4, 16, 2
    meta = dict(device="meta")
    q = torch.empty((B, Q, Hq, hd), **meta)
    pools = [torch.empty((NB, Hkv, BS, hd), **meta) for _ in range(2)]
    i8 = [torch.empty((NB, Hkv, BS, hd), dtype=torch.int8, **meta)
          for _ in range(2)]
    scales = [torch.empty((NB, Hkv, BS), **meta) for _ in range(2)]
    tables = torch.empty((B, MB), dtype=torch.int32, **meta)
    lengths = torch.empty((B,), dtype=torch.int32, **meta)
    for fn in (tpa.paged_flash_attention, tpa.paged_flash_attention_deep):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(q, *pools, tables, lengths)
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(q, *i8, tables, lengths, *scales)
        assert fn.launches == 0 and fn.int8_launches == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        tda.flash_decode(q[:, 0], torch.empty((B, Hkv, 64, hd), **meta),
                         torch.empty((B, Hkv, 64, hd), **meta), lengths)
    assert tda.flash_decode.launches == 0


def test_kernel_args_are_checked():
    """What the kernels do not take is refused before any launch: an
    int8 pool without scales, scales with an fp pool, mismatched scale
    shapes."""
    B, Q, Hq, Hkv, hd, NB, BS, MB = 2, 1, 4, 2, 128, 4, 16, 2
    q = torch.zeros((B, Q, Hq, hd), dtype=torch.bfloat16)
    i8 = torch.zeros((NB, Hkv, BS, hd), dtype=torch.int8)
    bf = torch.zeros((NB, Hkv, BS, hd), dtype=torch.bfloat16)
    sc = torch.zeros((NB, Hkv, BS))
    tables = torch.zeros((B, MB), dtype=torch.int32)
    lengths = torch.zeros((B,), dtype=torch.int32)
    tpa.check_args(q, bf, bf, tables, lengths, None, None)
    tpa.check_args(q, i8, i8, tables, lengths, sc, sc)
    for pools, scales in (
        ((i8, i8), (None, None)),
        ((bf, bf), (sc, sc)),
        ((i8, i8), (sc, None)),
        ((i8, i8), (sc[:, :, :8], sc[:, :, :8])),
        ((i8, i8), (sc.double(), sc.double())),
    ):
        with pytest.raises(ValueError):
            tpa.check_args(q, *pools, tables, lengths, *scales)


def test_kernel_source_targets_hopper():
    for name, entry in (("paged_attention", "paged_attention_fwd"),
                        ("paged_attention_deep", "paged_attention_deep_fwd"),
                        ("paged_attention_deep", "flash_decode_fwd")):
        src = (REPO / f"areal_tpu_torch/csrc/{name}.cu").read_text()
        assert entry in src
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize(
    "kw",
    [
        dict(prefix_cache=True),
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
