"""janus_tpu_torch/aggregator/prewarm.py and aot_cache.py against
janus_tpu's prewarm, the canary's re-warm, the boot warmup's dedupe and a
driver binary booted with a manifest.

- `prewarm_engines` on one manifest, with a stub warmer on a fake clock,
  yields janus_tpu's priority set, deferred set and outcome counts
  (`warmed`, `failed`, `unsupported`, `no_task`, `deferred`,
  `geometry_mismatch`);
- a real CPU prewarm of a Count task's entries dispatches exactly the
  recorded keys, and a later dispatch at those keys books `execute`, not
  `compile`, in the device-cost ledger; the canary's restore replays them;
- `warmup_engines` skips a bucket the prewarm dispatched
  (`skipped_covered`), and warms it where the prewarm did not run;
- the /statusz `engine_prewarm` section has janus_tpu's keys, less the
  named difference (the `aot` slice's `nvcc_s`);
- `aot_cache`: `arm` moves the library path, the host fingerprint is part
  of the key, a library whose sidecar names another fingerprint (or whose
  digest is off) is deleted before any load, and two builders on one
  directory share one build, with a fake library and no nvcc;
- a job driver binary booted from YAML with a shape manifest and
  `prewarm: true`: /debug/boot carries `engine_warm_manifest`, /readyz
  answers only once the priority set is warm, and /statusz carries
  `engine_prewarm`, which the port's scrape_check accepts.

One module-scoped janus_tpu reference (its prewarm module); tolerance:
exact equality.
"""

import base64
import json
import secrets
import signal
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import janus_tpu.aggregator.prewarm as jpw
import janus_tpu_torch.aggregator.prewarm as tpw
from janus_tpu_torch.aggregator import aot_cache, shape_manifest
from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.ops import cuda_build
from janus_tpu_torch.profiler import DEVICE_COST
from janus_tpu_torch.tools.chaos_run import seed_manifest
from janus_tpu_torch.vdaf.registry import VdafInstance

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    tpw.reset_for_tests()
    aot_cache.reset_for_tests()
    yield
    shape_manifest.uninstall_manifest()
    tpw.reset_for_tests()
    aot_cache.reset_for_tests()
    t_ec.engine_cache.cache_clear()


# --- the priority loop against janus_tpu's, on a stub warmer ---------------


def _stub_manifest(mod, path):
    """Costs chosen so a 20 s budget defers one entry at once (cost 50 >
    2 x 20) and the rest after the budget is spent; one entry has no task,
    one was recorded under a mesh, one is an unknown variant, one fails."""
    m = mod.ShapeManifest(str(path))
    count, sumvec = {"kind": "count"}, {"kind": "sumvec", "bits": 4, "length": 3, "chunk_length": 2}
    m.record(count, "leader_init", 256, ("leader_init", 256), 50.0)
    for i, b in enumerate((32, 64, 128, 256, 512, 1024)):
        m.record(count, "aggregate", b, ("aggregate", b), 9.0 - i)
    m.record(count, "leader_init", 64, ("leader_init", 64, "mesh", 2, 1, 2), 8.5)
    m.record(count, "helper_init", 64, ("odd", 64), 7.5)
    m.record(count, "helper_init", 32, ("boom", 32), 6.5)
    m.record(sumvec, "aggregate", 32, ("aggregate", 32), 9.5)
    return m


def _run_stub(mod, monkeypatch, tmp_path, vdaf_cls):
    now = [0.0]
    calls = []

    def warm(self, eng, entry):
        calls.append((entry["op"], entry["bucket"], tuple(entry["key"]), threading.current_thread().name))
        now[0] += float(entry["cost_s"]) / 2
        key = entry["key"]
        if key[0] == "boom":
            raise RuntimeError("device error")
        if "mesh" in key:
            return "geometry_mismatch"
        if key[0] == "odd":
            return "unsupported"
        return "warmed"

    monkeypatch.setattr(mod, "time", SimpleNamespace(monotonic=lambda: now[0]))
    monkeypatch.setattr(mod._Warmer, "warm", warm)
    import importlib

    ec = importlib.import_module(mod.__name__.rsplit(".", 1)[0] + ".engine_cache")
    monkeypatch.setattr(ec, "engine_cache", lambda *a, **k: SimpleNamespace(a=a))
    tasks = [SimpleNamespace(vdaf=vdaf_cls.count(), vdaf_verify_key=bytes(16))]
    ds = SimpleNamespace(run_tx=lambda fn, name=None: fn(SimpleNamespace(get_tasks=lambda: tasks)))
    before = {k: mod._STATE.get(k, 0) for k in tpw.OUTCOMES}
    ready = threading.Event()
    summary = mod.prewarm_engines(ds, _stub_manifest(mod.shape_manifest, tmp_path / mod.__name__),
                                  boot_budget_s=20.0, ready_event=ready, background_remainder=False)
    counts = {k: mod._STATE.get(k, 0) - before[k] for k in tpw.OUTCOMES}
    return summary, calls, counts, ready.is_set(), mod._STATE["state"]


def test_prewarm_order_deferral_and_counts_equal_janus_tpus(monkeypatch, tmp_path):
    from janus_tpu.vdaf.registry import VdafInstance as JVdaf

    got = {"t": _run_stub(tpw, monkeypatch, tmp_path, VdafInstance),
           "j": _run_stub(jpw, monkeypatch, tmp_path, JVdaf)}
    assert got["t"] == got["j"]
    summary, calls, counts, ready, state = got["t"]
    # highest recorded cost first, the 50 s entry deferred at once, the
    # budget spent after six warms (a warm advances the clock cost / 2)
    assert [c[2] for c in calls] == [("aggregate", 32), ("leader_init", 64, "mesh", 2, 1, 2), ("aggregate", 64),
                                     ("odd", 64), ("aggregate", 128), ("boom", 32)]
    assert summary == {"entries": 11, "warmed": 3, "deferred": 4, "priority_elapsed_s": 23.25}
    assert counts == {"warmed": 3, "failed": 1, "unsupported": 1, "no_task": 1, "deferred": 4,
                      "geometry_mismatch": 1}
    assert ready and state == "ready"


# --- a real prewarm on the CPU ----------------------------------------------


def _count_task(vk: bytes):
    inst = VdafInstance.count()
    task = SimpleNamespace(vdaf=inst, vdaf_verify_key=vk)
    ds = SimpleNamespace(run_tx=lambda fn, name=None: fn(SimpleNamespace(get_tasks=lambda: [task])))
    return inst, ds


def _rows(kind, op, bucket):
    ent = next((e for e in DEVICE_COST.status()["entries"] if (e["vdaf"], e["op"], e["bucket"]) == (kind, op, bucket)),
               None)
    return (ent["compile_s"], ent["dispatches"]) if ent else (0.0, 0)


def _batch(inst, n, seed):
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    return make_report_batch(inst, random_measurements(inst, n, np.random.default_rng(seed)), seed=seed,
                             device=CPU)[0]


def test_cpu_prewarm_warms_exactly_the_recorded_keys(tmp_path):
    vk = secrets.token_bytes(16)
    inst, ds = _count_task(vk)
    path = tmp_path / "m.jsonl"
    assert seed_manifest(str(path), (inst,)) == 10
    manifest = shape_manifest.install_manifest(str(path))
    want = {tuple(e["key"]) for e in manifest.entries()}
    summary = tpw.prewarm_engines(ds, manifest, devices=[CPU])
    assert (summary["entries"], summary["warmed"], summary["deferred"]) == (10, 10, 0)
    st = tpw.engine_prewarm_status()["prewarm"]
    assert (st["state"], st["warmed"], st["failed"], st["cache_hits"], st["cache_misses"]) == ("done", 10, 0, 10, 0)
    eng = t_ec.engine_cache(inst, vk, devices=[CPU])
    assert eng._ledger_dispatched == want
    # a served dispatch at a recorded key books execute, not compile
    before = {k: _rows("count", *k) for k in (("leader_init", 32), ("aggregate", 32))}
    args = _batch(inst, 20, 3)
    out0 = eng.leader_init(*args[:5])[0]
    eng.aggregate(out0, np.ones(20, dtype=bool))
    for key, (compile_s, dispatches) in before.items():
        assert _rows("count", *key) == (compile_s, dispatches + 1), key
    # the prewarm's own dispatches re-recorded the same keys, nothing new
    assert {tuple(e["key"]) for e in shape_manifest.installed().entries()} == want


def test_sparse_prewarm_warms_the_scatter(tmp_path):
    """A block-sparse task's recorded scatter_merge (kernel 4's dispatch)
    and leader init warm on the CPU through the engine's own entry
    points; an entry of another mesh geometry does not."""
    vk = secrets.token_bytes(16)
    inst = VdafInstance.sparse_sumvec(3, 48, 4, 3)
    task = SimpleNamespace(vdaf=inst, vdaf_verify_key=vk)
    ds = SimpleNamespace(run_tx=lambda fn, name=None: fn(SimpleNamespace(get_tasks=lambda: [task])))
    man = shape_manifest.install_manifest(str(tmp_path / "m.jsonl"))
    for op, key in (("leader_init", ("leader_init", 32)), ("scatter_merge", ("scatter_merge", 32)),
                    ("leader_init", ("leader_init", 64, "mesh", 2, 1, 2))):
        man.record(inst.to_dict(), op, 32 if len(key) == 2 else 64, key, 1.0)
    summary = tpw.prewarm_engines(ds, man, devices=[CPU])
    st = tpw.engine_prewarm_status()["prewarm"]
    assert (summary["warmed"], st["geometry_mismatch"], st["failed"]) == (2, 1, 0)
    eng = t_ec.engine_cache(inst, vk, devices=[CPU])
    assert {("leader_init", 32), ("scatter_merge", 32)} <= eng._ledger_dispatched


def test_canary_restore_rewarms_from_the_manifest(tmp_path):
    """The port's quarantine and restore drop nothing a dispatch reuses,
    so the canary's re-warm replays warm dispatches: `rewarmed` counts
    them, and the ledger books them execute."""
    vk = secrets.token_bytes(16)
    inst = VdafInstance.count()
    eng = t_ec.EngineCache(inst, vk, device="cpu")
    eng.QUARANTINE_CANARY_DELAY_SECS = 0.05
    shape_manifest.install_manifest(str(tmp_path / "m.jsonl"))
    args = _batch(inst, 8, 4)
    eng.aggregate(eng.leader_init(*args[:5])[0], np.ones(8, dtype=bool))
    assert len(shape_manifest.installed().entries()) == 2
    before = {k: _rows("count", *k) for k in (("leader_init", 32), ("aggregate", 32))}
    eng._quarantine_on_hang("test")
    deadline = time.monotonic() + 30
    while eng.quarantine_stats["rewarmed"] < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert eng.quarantine_stats["restored"] == 1 and eng.quarantine_stats["rewarmed"] == 2
    for key, (compile_s, dispatches) in before.items():
        got = _rows("count", *key)
        assert got[0] == compile_s and got[1] > dispatches, key
    eng.stop_canary()


def test_warmup_skips_what_the_manifest_covers(tmp_path):
    """The boot warmup skips a bucket whose three ops the manifest prewarm
    already dispatched in this process, and warms it where the prewarm did
    not run."""
    from janus_tpu_torch.binary_utils import warmup_engines

    vk = secrets.token_bytes(16)
    inst, _ = _count_task(vk)
    task = SimpleNamespace(vdaf=inst, vdaf_verify_key=vk, task_id=SimpleNamespace(data=b"t" * 32))
    ds = SimpleNamespace(run_tx=lambda fn, name=None: fn(SimpleNamespace(get_tasks=lambda: [task])))
    # no prewarm: the bucket warms
    got = warmup_engines(ds, batch=20, devices=[CPU])
    assert got == {"warmed": [(task.task_id, 32)], "skipped_covered": 0}
    t_ec.engine_cache.cache_clear()
    man = shape_manifest.ShapeManifest(str(tmp_path / "m.jsonl"))
    seed_manifest(man.path, (inst,))
    man.load()
    assert tpw.prewarm_engines(ds, man, devices=[CPU])["warmed"] == 10
    got = warmup_engines(ds, batch=20, devices=[CPU])
    assert got == {"warmed": [], "skipped_covered": 1}
    # a bucket the manifest does not cover warms
    assert warmup_engines(ds, batch=300, devices=[CPU])["warmed"] == [(task.task_id, 512)]


# --- the statusz section ----------------------------------------------------


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_statusz_section_has_janus_tpus_keys_less_the_named():
    j, t = _key_tree(jpw.engine_prewarm_status()), _key_tree(tpw.engine_prewarm_status())
    assert set(t) == set(j) == {"compile_cache", "aot", "manifest", "prewarm"}
    for part in ("compile_cache", "manifest", "prewarm"):
        assert t[part] == j[part], part
    # named: the kernel-library cache reports its nvcc seconds
    assert set(t["aot"]) - set(j["aot"]) == {"nvcc_s"} and set(j["aot"]) <= set(t["aot"])
    from janus_tpu_torch.statusz import status_snapshot

    assert "engine_prewarm" in status_snapshot()


# --- the kernel-library cache -----------------------------------------------


def test_arm_moves_the_library_path_and_the_fingerprint_keys_it(monkeypatch, tmp_path):
    unarmed = cuda_build._lib_path("keccak")
    assert unarmed.parent == cuda_build.BUILD_DIR and aot_cache.armed_dir() is None
    aot_cache.arm(str(tmp_path / "aot"))
    armed = cuda_build._lib_path("keccak")
    assert armed.parent == tmp_path / "aot" and armed.name == unarmed.name
    st = aot_cache.status()
    assert (st["enabled"], st["dir"], st["blobs"]) == (True, str(tmp_path / "aot"), 0)
    monkeypatch.setattr(cuda_build, "host_fingerprint", lambda: "another-nvcc")
    assert cuda_build._lib_path("keccak") != armed
    aot_cache.disarm()
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR


def _fake_library(lib, fp):
    lib.parent.mkdir(parents=True, exist_ok=True)
    lib.write_bytes(b"\x7fELF" + bytes(60))
    cuda_build._sidecar(lib).write_text(json.dumps({"v": 1, "fp": fp, "sha256": cuda_build._digest(lib)}))


@pytest.mark.parametrize("fault", ["foreign", "corrupt", "no_sidecar"])
def test_refused_library_is_deleted_before_any_load(monkeypatch, tmp_path, fault):
    """A library whose sidecar names another host's fingerprint, whose
    digest is off, or that has no sidecar is deleted and rebuilt (here by a
    stub nvcc) before ctypes opens anything."""
    monkeypatch.setattr(cuda_build, "host_fingerprint", lambda: "this-host")
    aot_cache.arm(str(tmp_path))
    lib = cuda_build._lib_path("keccak")
    _fake_library(lib, "other-host" if fault == "foreign" else "this-host")
    if fault == "corrupt":
        lib.write_bytes(b"\x7fELF" + bytes(59))
    if fault == "no_sidecar":
        cuda_build._sidecar(lib).unlink()
    events = []

    class Nvcc:
        def __init__(self, cmd, **kw):
            events.append(("nvcc", lib.exists()))
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF built")
            self.returncode = 0

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", Nvcc)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: events.append(("load", Path(path).read_bytes())))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_built_here", set())
    cuda_build.load("keccak")
    # deleted first, rebuilt, sealed with this host's fingerprint, loaded
    assert events == [("nvcc", False), ("load", b"\x7fELF built")]
    assert cuda_build.library_ok(lib)
    st = aot_cache.stats()
    assert (st["errors"], st["saves"], st["loads"], st["bytes_saved"]) == (1, 1, 0, len(b"\x7fELF built"))


def test_own_library_loads_and_counts(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "host_fingerprint", lambda: "this-host")
    aot_cache.arm(str(tmp_path))
    lib = cuda_build._lib_path("expand_f128")
    _fake_library(lib, "this-host")
    assert cuda_build.library_ok(lib) and lib.exists()
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: SimpleNamespace(path=path))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: pytest.fail("a cached library needs no nvcc"))
    assert cuda_build.load("expand_f128").path == str(lib)
    st = aot_cache.status()
    assert (st["loads"], st["saves"], st["errors"], st["blobs"]) == (1, 0, 0, 1)
    assert st["blob_bytes"] == lib.stat().st_size


def test_concurrent_builders_share_one_build_and_never_expose_a_bare_library(monkeypatch, tmp_path):
    """Two builders on one armed directory (replicas booting on one host):
    the second waits on the directory's lock and finds the first's
    library, and no library is ever in place without its sidecar."""
    monkeypatch.setattr(cuda_build, "host_fingerprint", lambda: "this-host")
    aot_cache.arm(str(tmp_path))
    lib = cuda_build._lib_path("keccak")
    nvcc_runs = []
    bare = []
    real_replace = cuda_build.os.replace

    def replace(src, dst):
        if str(dst).endswith(".so"):
            bare.append(not cuda_build._sidecar(Path(dst)).exists())
        real_replace(src, dst)

    class Nvcc:
        def __init__(self, cmd, **kw):
            self.out = Path(cmd[cmd.index("-o") + 1])
            nvcc_runs.append(self.out)
            self.returncode = 0

        def communicate(self):
            time.sleep(0.3)
            self.out.write_bytes(b"\x7fELF built")
            return "ptxas info", None

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", Nvcc)
    monkeypatch.setattr(cuda_build.os, "replace", replace)
    monkeypatch.setattr(cuda_build, "_built_here", set())
    errors = []

    def builder():
        try:
            cuda_build.build(["keccak"])
            assert cuda_build.library_ok(lib)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=builder) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(nvcc_runs) == 1 and bare == [False]
    st = aot_cache.stats()
    assert (st["saves"], st["errors"]) == (1, 0)
    assert cuda_build.library_ok(lib) and lib.read_bytes() == b"\x7fELF built"


# --- a driver binary booted with a manifest ---------------------------------


def test_driver_binary_prewarms_before_ready(tmp_path):
    from test_torch_binaries import fetch, port_env, spawn, wait_ready

    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.time_util import RealClock
    from janus_tpu_torch.datastore.store import Crypter, open_datastore
    from janus_tpu_torch.messages import Role
    from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder
    from janus_tpu_torch.tools import scrape_check
    from janus_tpu_torch.tools.chaos_run import _free_port

    key_bytes = secrets.token_bytes(16)
    key = base64.urlsafe_b64encode(key_bytes).decode().rstrip("=")
    db = str(tmp_path / "leader.sqlite")
    ds = open_datastore(db, Crypter([key_bytes]), RealClock())
    task = TaskBuilder(QueryTypeConfig.time_interval(), VdafInstance.count(), Role.LEADER).with_(
        collector_hpke_config=generate_hpke_config_and_private_key(config_id=9).config).build()
    ds.run_tx(lambda tx: tx.put_task(task), "provision")
    ds.close()
    cache = tmp_path / "cache"
    assert seed_manifest(str(cache / "shape_manifest.jsonl"), (VdafInstance.count(),)) == 10
    port = _free_port()
    cfg = tmp_path / "driver.yaml"
    cfg.write_text(yaml.safe_dump({
        "database": {"url": db}, "health_check_listen_address": f"127.0.0.1:{port}", "device": "cpu",
        "compilation_cache_dir": str(cache), "engine": {"prewarm": True, "prewarm_boot_budget_secs": 120},
    }))
    log = tmp_path / "driver.log"
    proc = spawn("janus_tpu_torch", "aggregation_job_driver", cfg, port_env(key), log)
    try:
        wait_ready(port, proc, log)
        base = f"http://127.0.0.1:{port}"
        # the first 200 from /readyz: the priority set is already warm
        ep = json.loads(fetch(base + "/statusz")[2])["engine_prewarm"]
        assert ep["prewarm"]["state"] == "done" and ep["prewarm"]["warmed"] == 10 and ep["prewarm"]["failed"] == 0
        assert ep["manifest"]["installed"] and ep["manifest"]["entries"] == 10
        assert ep["compile_cache"]["dir"] == str(cache) and ep["aot"]["enabled"]
        assert ep["aot"]["dir"] == str(cache / "aot")
        boot = json.loads(fetch(base + "/debug/boot")[2])
        phases = [p["phase"] for p in boot["phases"]]
        assert phases.index("engine_warm_manifest") < phases.index("engine_warm") < phases.index("listener_up")
        assert scrape_check.main(["--url", base, "--statusz"]) == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0 and "shut down" in log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
