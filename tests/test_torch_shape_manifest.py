"""janus_tpu_torch/aggregator/shape_manifest.py against
janus_tpu/aggregator/shape_manifest.py, and the engine's record of its
first dispatches.

- the same `record()` sequence writes byte-identical files in both
  packages (one clock), and each package's `load()` reads the other's:
  torn tail, bad CRC, version skew, compaction at `max_entries`, with the
  same counts and the same rewritten bytes;
- `entry_key`, `entry_geometry` and `covers` answer alike; the installed
  manifest (`install_manifest`, `record_dispatch`, `manifest_status`,
  `inspect_file`) behaves alike, fakes and Poplar1 unrecorded;
- a port engine on the CPU records the first dispatch of each
  specialization under janus_tpu's key: the same (op, bucket, key)
  entries as a janus_tpu engine (JAX on the CPU, one device) fed the same
  calls, the view and aggregate_pending variants included; a mesh engine
  suffixes ("mesh", dp, sp, device count).

One module-scoped janus_tpu reference (its manifest module and a Count
engine's recorded entries); tolerance: exact equality.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import janus_tpu.aggregator.shape_manifest as jsm
import janus_tpu_torch.aggregator.shape_manifest as tsm
from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.vdaf.registry import VdafInstance

CLOCK = 1_760_000_123.456
VK = bytes(range(16))
COUNT = {"kind": "count"}
SUMVEC = {"kind": "sumvec", "bits": 4, "length": 3, "chunk_length": 2}


@pytest.fixture(autouse=True)
def _clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: CLOCK)


def _records():
    """A record() sequence with repeats (seen counts, max cost), every
    key shape (variants, kk geometry, a mesh suffix) and float costs."""
    out = []
    for b in (32, 64, 128):
        for op in ("leader_init", "helper_init", "aggregate"):
            out.append((COUNT, op, b, (op, b), b / 10 + 0.1234567, b))
    out += [
        (SUMVEC, "aggregate_pending", 64, ("aggregate_pending", 8, 64), 3.0, 40),
        (SUMVEC, "leader_init", 32, ("leader_init_vk", 32), 1.5, 20),
        (SUMVEC, "aggregate", 32, ("aggregate_view_32", 32), 0.25, 8),
        (COUNT, "leader_init", 64, ("leader_init", 64, "mesh", 2, 1, 2), 0.75, 40),
        (COUNT, "leader_init", 32, ("leader_init", 32), 0.01, 3),  # a repeat: cost stays 3.2345
        (COUNT, "scatter_merge", 32, ("scatter_merge", 32), 2.0, 17),
    ]
    return out


def _write(mod, path, max_entries=512, records=None):
    m = mod.ShapeManifest(str(path), max_entries=max_entries)
    for rec in records or _records():
        m.record(*rec[:5], rows=rec[5])
    return m


def test_record_writes_janus_tpus_bytes_and_each_reads_the_other(tmp_path):
    jm, tm = _write(jsm, tmp_path / "j.jsonl"), _write(tsm, tmp_path / "t.jsonl")
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert tm.entries() == jm.entries() and tm.status()["entries"] == jm.status()["entries"] == 14
    for reader, path in ((tsm, "j.jsonl"), (jsm, "t.jsonl")):
        m = reader.ShapeManifest(str(tmp_path / path))
        assert m.load() == {"lines": 15, "loaded": 15, "skipped_corrupt": 0, "skipped_version": 0}
        assert m.entries() == jm.entries()
    # the repeat kept the larger cost and counted the sighting
    rep = next(e for e in tm.entries() if e["op"] == "leader_init" and e["bucket"] == 32 and e["vdaf"] == COUNT
               and e["key"] == ["leader_init", 32])
    assert (rep["seen"], rep["cost_s"], rep["rows"]) == (2, 3.323457, 3)


def test_damage_is_skipped_and_compacted_alike(tmp_path):
    _write(tsm, tmp_path / "base.jsonl")
    good = (tmp_path / "base.jsonl").read_bytes()
    bad_crc = json.dumps({"v": 1, "crc": 7, "e": {"vdaf": COUNT, "op": "x", "bucket": 32, "key": ["x", 32]}})
    skew = json.dumps({"v": 2, "crc": 0, "e": {}})
    damaged = good + (bad_crc + "\n" + skew + "\nnot json\n" + '{"v": 1, "crc": 12').encode()
    got = {}
    for name, mod in (("t", tsm), ("j", jsm)):
        path = tmp_path / f"{name}.jsonl"
        path.write_bytes(damaged)
        # read-only inspection leaves the evidence as it was
        entries, stats = mod.inspect_file(str(path))
        assert path.read_bytes() == damaged
        m = mod.ShapeManifest(str(path))
        got[name] = (entries, stats, m.load(), m.entries(), m.status()["compactions"], path.read_bytes())
    assert got["t"] == got["j"]
    _, stats, load, entries, compactions, rewritten = got["t"]
    assert stats == load == {"lines": 19, "loaded": 15, "skipped_corrupt": 3, "skipped_version": 1}
    assert len(entries) == 14 and compactions == 1 and len(rewritten.splitlines()) == 14


@pytest.mark.parametrize("max_entries", [1, 4, 13])
def test_compaction_at_max_entries_alike(tmp_path, max_entries):
    jm = _write(jsm, tmp_path / "j.jsonl", max_entries=max_entries)
    tm = _write(tsm, tmp_path / "t.jsonl", max_entries=max_entries)
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert tm.entries() == jm.entries() and len(tm.entries()) == max_entries
    assert tm.status()["compactions"] == jm.status()["compactions"] > 0
    # the highest recorded costs survive
    assert [e["cost_s"] for e in tm.entries()] == sorted((e["cost_s"] for e in tm.entries()), reverse=True)


def test_keys_geometry_and_coverage_alike(tmp_path):
    jm, tm = _write(jsm, tmp_path / "j.jsonl"), _write(tsm, tmp_path / "t.jsonl")
    for e in tm.entries():
        assert tsm.entry_key(e) == jsm.entry_key(e)
        assert tsm.entry_geometry(e["key"]) == jsm.entry_geometry(e["key"])
    assert tsm.entry_geometry(["leader_init", 64, "mesh", 2, 1, 2]) == (2, 1, 2)
    assert tsm.entry_geometry(["leader_init", 64]) is None
    assert tsm.entry_geometry(["x", "mesh", "a", 1, 2]) is None
    cases = [(v, op, b, g) for v in (COUNT, SUMVEC) for op in ("leader_init", "helper_init", "aggregate")
             for b in (32, 64, 256) for g in (None, (2, 1, 2))]
    answers = [tm.covers(*c[:3], geometry=c[3]) for c in cases]
    assert answers == [jm.covers(*c[:3], geometry=c[3]) for c in cases]
    assert tm.covers(COUNT, "leader_init", 64, geometry=(2, 1, 2)) and tm.covers(COUNT, "aggregate", 128)
    # a `_vk` or view entry covers no plain variant
    assert not tm.covers(SUMVEC, "leader_init", 32) and not tm.covers(SUMVEC, "aggregate", 32)


def test_installed_manifest_alike(tmp_path):
    from janus_tpu.vdaf.registry import VdafInstance as JVdaf

    try:
        got = {}
        for name, mod, vdaf in (("t", tsm, VdafInstance), ("j", jsm, JVdaf)):
            assert mod.manifest_status() == {"installed": False} and mod.installed() is None
            mod.record_dispatch(vdaf.count(), "leader_init", 32, ("leader_init", 32), 1.0)  # none installed
            path = tmp_path / name / mod.DEFAULT_FILENAME
            m = mod.install_manifest(str(path), max_entries=8)
            assert mod.installed() is m
            mod.record_dispatch(vdaf.count(), "leader_init", 32, ("leader_init", 32), 1.0, rows=9)
            mod.record_dispatch(vdaf.sum_vec(3, 4), "aggregate", 64, ("aggregate", 64), 0.5, rows=33)
            mod.record_dispatch(vdaf("fake"), "aggregate", 64, ("aggregate", 64), 0.5)
            mod.record_dispatch(vdaf("poplar1", bits=8), "aggregate", 64, ("aggregate", 64), 0.5)
            st = mod.manifest_status()
            st.pop("path")
            got[name] = (path.read_bytes(), st, mod.inspect_file(str(path)))
            mod.uninstall_manifest()
            assert mod.installed() is None
        assert got["t"] == got["j"]
        assert got["t"][1]["entries"] == 2 and got["t"][1]["max_entries"] == 8
    finally:
        tsm.uninstall_manifest()
        jsm.uninstall_manifest()


# --- the engine's record of its first dispatches ---------------------------


def _calls(eng, make_batch):
    """The same engine calls in both packages: an init pair and an
    aggregate at 8 rows (bucket 32), a 40-row init (bucket 64) with an
    8-row view of it aggregated (janus_tpu's aggregate_view_32), and an
    aggregate_pending of 3 buckets (kk 4)."""
    args = make_batch(8, 0)
    nonce, parts, meas, proof, blind0, hseed, blind1 = args
    out0, _, ver0, part0 = eng.leader_init(nonce, parts, meas, proof, blind0)
    ok = np.ones(8, dtype=bool)
    if part0 is None:
        part0 = np.zeros((8, 2), dtype=np.uint64)
    eng.helper_init(nonce, parts, hseed, blind1, ver0, part0, ok)
    eng.aggregate(out0, ok)
    big = make_batch(40, 1)
    out_big = eng.leader_init(*big[:5])[0]
    view = out_big.view(0, 8) if hasattr(out_big, "view") else type(out_big)(out_big.value, 8, offset=0)
    eng.aggregate(view, np.ones(8, dtype=bool))
    eng.aggregate_pending(out0, (np.arange(8) % 3).astype(np.int32), 3)


def _recorded(mod, path):
    return sorted((e["op"], e["bucket"], tuple(e["key"])) for e in mod.inspect_file(str(path))[0])


@pytest.fixture(scope="module")
def janus_tpu_count_entries(tmp_path_factory):
    """The entries a janus_tpu Count engine (JAX on the CPU, one device)
    records for `_calls`."""
    from janus_tpu.aggregator.engine_cache import EngineCache
    from janus_tpu.vdaf.registry import VdafInstance as JVdaf
    from janus_tpu.vdaf.testing import make_report_batch, random_measurements

    mp = pytest.MonkeyPatch()
    mp.setenv("JANUS_MESH_DP", "1")
    mp.setenv("JANUS_MESH_SP", "1")
    path = tmp_path_factory.mktemp("jman") / "m.jsonl"
    jsm.install_manifest(str(path))
    try:
        inst = JVdaf.count()
        eng = EngineCache(inst, VK)
        assert eng.mesh is None

        def batch(n, seed):
            return make_report_batch(inst, random_measurements(inst, n, np.random.default_rng(seed)), seed=seed)[0]

        _calls(eng, batch)
        return _recorded(jsm, path)
    finally:
        jsm.uninstall_manifest()
        mp.undo()


def _port_entries(tmp_path, devices=None):
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    path = tmp_path / "t.jsonl"
    tsm.install_manifest(str(path))
    try:
        inst = VdafInstance.count()
        eng = t_ec.EngineCache(inst, VK, device="cpu", devices=devices)

        def batch(n, seed):
            meas = random_measurements(inst, n, np.random.default_rng(seed))
            return make_report_batch(inst, meas, seed=seed, device=torch.device("cpu"))[0]

        _calls(eng, batch)
        return eng, _recorded(tsm, path)
    finally:
        tsm.uninstall_manifest()


def test_engine_records_janus_tpus_keys(tmp_path, janus_tpu_count_entries):
    eng, entries = _port_entries(tmp_path)
    assert entries == janus_tpu_count_entries
    assert ("aggregate", 32, ("aggregate_view_32", 32)) in entries
    assert ("aggregate_pending", 32, ("aggregate_pending", 4, 32)) in entries
    # each first dispatch recorded once: a second round of calls adds none
    path = tmp_path / "again.jsonl"
    tsm.install_manifest(str(path))
    try:
        eng.aggregate(eng.leader_init(*_batch8())[0], np.ones(8, dtype=bool))
    finally:
        tsm.uninstall_manifest()
    assert not path.exists()


def _batch8():
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    inst = VdafInstance.count()
    return make_report_batch(inst, random_measurements(inst, 8, np.random.default_rng(5)), seed=5,
                             device=torch.device("cpu"))[0][:5]


def test_mesh_engine_suffixes_its_geometry(tmp_path):
    eng, entries = _port_entries(tmp_path, devices=["cpu", "cpu"])
    assert eng.mesh is not None and (eng.dp, eng.sp) == (2, 1)
    assert entries and all(key[-4:] == ("mesh", 2, 1, 2) for _, _, key in entries)
    assert all(tsm.entry_geometry(key) == (2, 1, 2) for _, _, key in entries)


def test_default_filename_and_version():
    assert (tsm.DEFAULT_FILENAME, tsm.MANIFEST_VERSION, tsm.DEFAULT_MAX_ENTRIES) == (
        jsm.DEFAULT_FILENAME, jsm.MANIFEST_VERSION, jsm.DEFAULT_MAX_ENTRIES)
    assert os.path.basename(tsm.DEFAULT_FILENAME) == "shape_manifest.jsonl"
