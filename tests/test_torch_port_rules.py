"""The rules janus_tpu_torch keeps: no JAX, the device is never chosen
silently, and the CPU never counts as a kernel launch."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import janus_tpu_torch
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.ops import expand_cuda, keccak_cuda
from janus_tpu_torch.parallel import api
from janus_tpu_torch.vdaf.circuits import Count, SumVec
from janus_tpu_torch.vdaf.prio3 import Prio3Batched
from janus_tpu_torch.vdaf.registry import VdafInstance, prio3_batched
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(Path(janus_tpu_torch.__file__).parent.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_janus_tpu(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path}: imports {mod}"
        assert top != "janus_tpu", f"{path}: imports {mod}"


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Prio3Batched(Count())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.two_party_step(VdafInstance.count(), bytes(16))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_report_batch(VdafInstance.count(), [0, 1])
    assert Prio3Batched(SumVec(length=2, bits=2), device="cpu").device == torch.device("cpu")


def test_wrappers_refuse_other_devices():
    meta = [torch.empty((2, 3), dtype=torch.int64, device="meta")] * 21
    with pytest.raises(ValueError):
        keccak_cuda.keccak_single_block(meta, 2)
    with pytest.raises(ValueError):
        expand_cuda.expand_f128(torch.empty((2, 4), dtype=torch.int64, device="meta"), 2, 10)


@pytest.mark.parametrize("kind", ["count", "sumvec"])
def test_cpu_run_leaves_launch_counters_at_zero(kind):
    inst = VdafInstance.count() if kind == "count" else VdafInstance.sum_vec(3, 2)
    keccak_cuda.keccak_single_block.launches = 0
    expand_cuda.expand_f128.launches = 0
    meas = random_measurements(inst, 3, np.random.default_rng(1))
    args, _ = make_report_batch(inst, meas, seed=2, device="cpu")
    agg0, agg1, count = api.two_party_step(inst, bytes(16), device="cpu")(*args)
    assert int(count) == 3
    p3 = prio3_batched(inst, "cpu")
    assert [int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))] == list(
        np.asarray(meas).sum(axis=0).reshape(-1)
    )
    assert keccak_cuda.keccak_single_block.launches == 0
    assert expand_cuda.expand_f128.launches == 0
