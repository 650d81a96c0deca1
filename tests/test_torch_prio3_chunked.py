"""janus_tpu_torch's two-party step held against janus_tpu's, chunked circuits.

The cases of test_torch_prio3.py (same procedure, same corruptions) for
the circuits whose query runs the limb contraction: SumVec(length=40,
bits=8) has 19 gadget calls of chunk 17, Histogram(7) 3 calls of 2. The
Histogram batch is sharded by both packages and crosses over.
"""

import pytest

from test_torch_prio3 import run_case


@pytest.mark.parametrize(
    "kind,jax_shards,kw",
    [
        ("sumvec", False, {"length": 40, "bits": 8}),
        ("histogram", True, {"length": 7}),
    ],
    ids=["SumVec40x8", "Histogram7"],
)
def test_two_party_and_helper_step_match_jax(kind, jax_shards, kw):
    run_case(kind, jax_shards, **kw)
