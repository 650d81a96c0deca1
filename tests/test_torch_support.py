"""janus_tpu_torch's support code: numpy conversion, the kernel build, the registry."""

import numpy as np
import pytest
import torch

from janus_tpu.fields.jfield import JF128
from janus_tpu_torch import convert
from janus_tpu_torch.fields.tfield import TF128
from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.vdaf.circuits import Histogram, SumVec
from janus_tpu_torch.vdaf.registry import VdafInstance, circuit_for

CPU = torch.device("cpu")


def test_u64_round_trip_keeps_every_bit():
    a = np.array([[0, 1, 2**63 - 1], [2**63, 2**64 - 2, 2**64 - 1]], dtype=np.uint64)
    t = convert.from_numpy_u64(a, CPU)
    assert t.dtype == torch.int64 and t.tolist()[1][0] == -(2**63)
    assert (convert.to_numpy_u64(t) == a).all()


def test_step_args_round_trip_with_field_values_and_none():
    rng = np.random.default_rng(1)
    lanes = rng.integers(0, 2**64 - 1, size=(3, 2), dtype=np.uint64, endpoint=True)
    ints = np.array([[1, 2**127 + 5], [0, 2**64]], dtype=object)
    field = JF128.from_ints(ints)  # a JAX limb tuple
    args = (lanes, None, field, field, None, lanes, None)
    port = convert.step_args_from_jax(args, CPU)
    assert port[1] is None and port[4] is None and port[6] is None
    assert [[int(x) for x in row] for row in TF128.to_ints(port[2])] == [[int(x) for x in row] for row in ints]
    back = convert.step_args_to_numpy(port)
    assert (back[0] == lanes).all()
    assert all((b == np.asarray(j)).all() for b, j in zip(back[3], field))
    again = convert.step_args_from_jax(back, CPU)
    assert all(torch.equal(a, b) for a, b in zip(again[2], port[2]))


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed for csrc/keccak.cu"):
        cuda_build.build(["keccak"])
    assert not list(tmp_path.glob("*.so"))


def test_build_is_keyed_by_source_headers_and_flags(monkeypatch):
    keccak = cuda_build._lib_path("keccak")
    assert keccak.parent == cuda_build.BUILD_DIR and keccak != cuda_build._lib_path("expand_f128")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build._lib_path("keccak") != keccak


def test_launch_error_raises():
    cuda_build.check(0, "ok")
    with pytest.raises(RuntimeError, match="error 9"):
        cuda_build.check(9, "keccak_single_block")


def test_registry_builds_the_slice_circuits_and_refuses_the_rest():
    sv = circuit_for(VdafInstance.sum_vec(1000, 16))
    assert isinstance(sv, SumVec)
    # the north-star geometry (Prio3SumVec(length=1000, bits=16))
    assert (sv.input_len, sv.chunk_length, sv.gadget_uses[0].calls, sv.proof_len) == (16000, 126, 127, 507)
    assert isinstance(circuit_for(VdafInstance.histogram(7)), Histogram)
    assert VdafInstance.sum_vec(40, 8, chunk_length=5).to_dict() == {
        "kind": "sumvec", "bits": 8, "length": 40, "chunk_length": 5
    }
    with pytest.raises(ValueError):
        circuit_for(VdafInstance("sumvec", bits=8, length=4, xof_mode="draft"))
    with pytest.raises(ValueError):
        circuit_for(VdafInstance("poplar1", bits=8))
