#!/usr/bin/env python3
"""Chip smoke test of janus_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which must pass:

  1. build         the four CUDA kernels from csrc/ (one nvcc per source,
                   all started together): the single-block Keccak, the fused
                   Field128 expansion, the whole draft sponge and the sparse
                   scatter-merge;
  2. kernels       each kernel against its plain PyTorch version on the
                   card, bit for bit, at the shapes of the paths that run it
                   (24 rounds, plus a reduced-round case), with its time, the
                   plain version's time and the least time the card could
                   take (bound); among them kernel 2 at the streamed query's
                   tile (128 reports, 8,848 blocks at block offset 25 x
                   8,848) and kernel 3 at draft SumVec(100000, 16)'s
                   152,382-block absorb (64 reports, 24 rounds), held against
                   hashlib.shake_128 on 4 reports, since its plain per-block
                   loop would take hours (its plain_ms is null); kernel 4
                   (the Field128 scatter-add of block-sparse SumVec) at the
                   sparse north star (1,024 reports x 1,024 compact lanes
                   into 1,000,000 positions, block 0 in every report) and
                   on a 64-row bucket with 3 rejected and 24 padding rows
                   (all sentinel);
  3. sumvec        the fast-mode main path: Prio3SumVec(length=1000, bits=16)
                   at batch 1024 through make_report_batch and two_party_step,
                   with a few reports corrupted; the count must exclude
                   exactly those, the two aggregate shares must sum to the
                   numpy ground truth, the path's kernels must have launched
                   during the step and the other kernels not (launch counts
                   are set to 0 just before the step and read just after); a
                   small batch must agree with the plain path on the CPU;
                   then two_party_step and helper_init_step are timed;
  4. count         Prio3Count at batch 8192, the same checks (the Field64
                   path, through the single-block kernel);
  5. draft-sumvec  the same SumVec in draft mode (VDAF-07 sponge: one
                   whole-sponge kernel launch per XOF call, none of the
                   fast-mode kernels) at batch 1024, the same checks, and one
                   step profiled; its small CPU batch runs at 3 Keccak rounds
                   on both sides, since the plain permutation's ~9,000
                   sequential calls at 24 rounds would take minutes on the
                   host (the kernel phase holds the kernel at 24 rounds);
  6. draft-count   Prio3Count in draft mode at batch 8192 (Field64
                   rejection sampling), the same checks;
  6a. sumvec100k   the north star Prio3SumVec(100000, 16) (1.6M Field128
                   inputs a report) at batch 32, fast mode, 3 corrupted,
                   the same checks (the small CPU batch is one report at 3
                   rounds, sharded on the card); its engine's stream plan
                   must be (tile 61,936, 49 calls, 26 steps): kernel 2
                   expands the helper's share a tile a step and the
                   leader's staged share is read a tile at a time. On 4 reports the streamed and the whole-share
                   route (stream_plan's threshold set past input_len) must
                   agree element for element, and every route's peak device
                   bytes must lie within vdaf/feasibility.py's model, which
                   the line prints beside them (the step's own peak: what
                   it adds to the card plus its reports' staged shares);
  6b. draft-sumvec100k  the same circuit in draft mode at batch 16, 24
                   rounds: kernel 3 alone launches, the helper's share is
                   expanded whole by the sponge and read a tile at a time;
                   no small CPU batch (the plain sponge cannot walk a
                   152,382-block chain in a run's time): the routes agree on
                   2 reports instead;
  6c. fixedpoint   Prio3FixedPointBoundedL2VecSum at FixedPointVec(1000,
                   16) (BASELINE.json configs[4]), batch 1024, fast mode, 3
                   corrupted, the same checks; the aggregate is the valid
                   reports' offset-binary sum and decodes to their float sum;
  6d. sparse      block-sparse SumVec at bench.py's sparse north star,
                   sparse_sumvec(16, 1000000, 64, 16), batch 1024, fast
                   mode: 1-16 blocks a report, uniform over the 15,625
                   logical blocks, block 0 in every report; 3 reports
                   corrupted and 1 with descending block indices on the
                   wire, which the index predicate (decode_index_columns)
                   must refuse alone. two_party_step over the compact
                   encoding (its count must exclude the 3, its aggregate
                   the compact sum), then EngineCache's leader and helper
                   init and both parties' aggregate_sparse (counts at 0
                   before the two-party step, read after the second
                   aggregate): kernels 1, 2 and 4 must launch, kernel 4
                   once a dispatch (the pipelined leader's 4 chunks of 256
                   rows, the helper's one bucket), kernel 3 never; the two logical shares
                   must sum to numpy's scatter-sum of the 1,020 valid
                   reports, and 4 reports must give the same shares on the
                   card and on the CPU. The line gives the steps' seconds,
                   each aggregate_sparse's, and the engine step's own peak
                   beside vdaf/feasibility.py's model;
  7. sponge        the draft-sumvec path's two long sponge chains (a
                   joint-rand part's 1,525-block absorb, a measurement
                   share's 1,524-block squeeze with sampling) at batch 1024,
                   one launch each, timed beside their bound;
  8. serve         the serving seam: a helper Aggregator built from a task
                   dict over an EphemeralDatastore answers one aggregate-init
                   request in DAP wire bytes for SumVec(1000, 16) at batch
                   1024, fast mode and draft mode. The leader's side shards
                   the reports, seals each helper share with HPKE, runs
                   EngineCache.leader_init over host columns (timed by the
                   direct and by the pipelined route) and frames one
                   AggregationJobInitializeReq with 3 corrupted leader
                   shares, 1 unknown HPKE config id and 1 report after the
                   task's expiration. Every other report must answer with
                   the leader's prep message, each reject with its error,
                   the leader's masked aggregate plus the helper's stored
                   share must unshard to the accepted reports' sum, the
                   path's kernels must launch during the request (counts
                   at 0 just before, read just after) and the others not,
                   and the same bytes sent again must get a byte-identical
                   answer and leave the batch aggregation as it was; the
                   same reports under a new job id (the whole path again,
                   warm) must all answer as replays. Last, the engine's
                   helper_init and the bare helper_init_step are timed in
                   turns on the request's reports. A third request serves
                   16 SumVec(100000, 16) reports (5 rejects injected) on the
                   fully streamed route, with the same checks.
  9. drive        the leader's side, for SumVec(1000, 16) in fast and in draft
                   mode: a leader and a helper Aggregator, each over its own
                   EphemeralDatastore, the helper behind a DapServer on
                   loopback (port 0). 1,024 reports sharded on the card, 3 of
                   them with a corrupted leader share, are stored through
                   put_client_report; AggregationJobCreator.run_once must
                   make one job of all 1,024, and JobDriver.run_once with one
                   worker steps it through AggregationJobDriver and the
                   HttpClient (counts at 0 just before, read just after). The
                   job must be finished with its lease released, exactly the
                   3 corrupted reports failed with VDAF_PREP_ERROR, the
                   leader's and the helper's stored shares must unshard to
                   the accepted reports' sum, and a second run_once must
                   acquire nothing. Then EngineCache.leader_init is timed on
                   the job's own staged columns by the route it takes at
                   1,024 reports (pipelined) and by the direct route, once
                   each, and the two must agree. In fast mode the leader,
                   behind its own DapServer, then collects the batch: a
                   port Collector PUTs a time-interval collection over the
                   job's window, CollectionJobDriver steps it through
                   JobDriver.run_once against the helper's DapServer
                   (counts at 0 just before, read just after: they must
                   stay 0, collection runs on the host), and the collector
                   polls and unshards: report_count 1,021 and the sum of
                   the accepted measurements, the collection job finished
                   with its lease released, a second run_once acquiring
                   nothing, a DELETE answered 204 and a later poll
                   answered with janus_tpu's unrecognizedCollectionJob
                   problem document. Then both MockClocks pass the task's
                   report_expiry_age and GarbageCollector.run_once must
                   clear the client reports, the aggregation jobs with
                   their report aggregations and the collection job of
                   both datastores. The draft drive is not collected: its
                   shares are Field128 bytes too, and run the same code.
  10. upload-drive-sumvec  the leader's intake, for SumVec(1000, 16) in
                   fast mode on a fixed-size task (max_batch_size 1,024): a
                   port leader and a port helper, each an Aggregator over its
                   own EphemeralDatastore behind its own DapServer. 8 reports
                   go through the port's Client (HPKE configs fetched over
                   HTTP, the host sharder, one upload each); 1,016 come from
                   make_wire_reports (the device shard, counts at 0 just
                   before and read just after; 3 of them opened, their
                   leader measurement share bumped inside the field, and
                   sealed again) and are PUT from 8 threads through the
                   HttpClient and retry_http_request. Every upload must end
                   in 201, a replay must add no row, a leader share with an
                   element >= p must get 400 reportRejected, and the leader
                   must hold 1,024 reports. AggregationJobCreator.run_once
                   must pack them into one job and one filled outstanding
                   batch; JobDriver.run_once steps the job (counts at 0 just
                   before, read just after): finished, lease released,
                   exactly the 3 bumped reports failed with
                   VDAF_PREP_ERROR, and the leader's and the helper's batch
                   aggregations, keyed by the job's BatchId, unshard to the
                   sum of the 1,021 accepted measurements. Then the batch is
                   collected as in phase 9 by a fixed-size current-batch
                   query (no GC).
  10a. upload-drive-sparse  the same for sparse_sumvec(16, 1000000, 64, 16)
                   (measurements as in phase 6d): besides, an upload whose
                   public share has descending block indices must get 400
                   invalidMessage and add no row; the stored batch
                   aggregations and the collection are 1,000,000 long and
                   must equal numpy's scatter-sum of the accepted reports.
                   The line also gives the host seconds at that length:
                   aggregate_sparse and encode_vec in the job step,
                   decode_vec in the collection.
  11. poplar1      Poplar1<XofShake128, 16>'s prepare at full width
                   (bench.py's configuration): the leaf level 15, 256
                   prefixes, 512 reports (alphas, prefixes and nonces from
                   numpy's generator at seed 0xB0B), 3 of them with a
                   mismatched helper key. prepare_init_batched runs for
                   both parties on the card (one warm-up, then the timed
                   two-party step, counts at 0 just before and read just
                   after): kernel 1 must launch 66 times (33 a party) and
                   kernels 2 and 3 not at all, the sketch (sigma0 + sigma1
                   == 0) must pass for exactly the 509 honest reports, and
                   y, A, B, a and c of 8 reports (a corrupted one among
                   them), both parties, must equal the host walk's. The
                   line gives the step's seconds and reports/s, the host
                   part of each call (keys to lanes, verify_rand, the
                   helper's corr_from_seed, the int conversions) beside
                   the device part (to torch.cuda.synchronize()), and the
                   peak device bytes;
  12. drive-poplar1  heavy hitters through DAP: a port leader and a port
                   helper, each behind its own DapServer, on a
                   time-interval Poplar1(16) task (max_batch_query_count
                   17). 1,024 reports uploaded by 8 threads through the
                   port's Client (host shard): 8 heavy values sent 48-96
                   times each, the rest uniform over [0, 2^16) (numpy's
                   generator), 3 of them corrupted as in phase 11. A port
                   Collector walks the 16 levels with threshold 32: at each
                   level one collection with Poplar1AggParam(level,
                   candidates), and JobDriver.run_once of the collection
                   and the aggregation drivers until it is done (two
                   512-report jobs a level, each an init and a continue
                   step). At every level report_count must be 1,021, each
                   prefix's count the numpy count over the honest
                   measurements, the survivors those of the ground truth;
                   kernel 1 must launch 2(L+1)+1 times per job on each side
                   in every init step (the helper's counted inside its
                   handler) and never in a continue or a collection step;
                   kernels 2 and 3 never. The final heavy set must be the
                   values sent at least 32 times. The line gives the upload
                   seconds and, per level, the create, init steps',
                   continue steps', collection steps' and poll seconds, the
                   helper's init and continue handler seconds and the
                   launches, then the total and the peak device bytes.
  13. taskprov-histogram  the rest of the protocol at full width: a port
                   leader on the Postgres engine (PostgresDatastore over the
                   port's pg_fake driver, the upload journal armed) and a
                   port helper on SQLite with taskprov enabled, holding one
                   active global HPKE keypair and the leader as its taskprov
                   peer. The task is a TaskConfig of Prio3Histogram with
                   9,999 boundaries (Prio3Histogram(10000), BASELINE.json
                   configs[3]), fast mode, time interval; the leader
                   provisions its side with the peer's derived verify key.
                   8 reports go through the port Client, whose helper config
                   must be the helper's global one; 1,016 come from
                   make_wire_reports (3 with a bumped leader share), PUT by
                   8 threads. The creator makes one job; JobDriver.run_once
                   steps it over an HTTP client that attaches the
                   dap-taskprov header (counts at 0 just before, read just
                   after: kernels 1 and 2 must launch, kernel 3 not), and the
                   helper must opt in on that first aggregate-init (no task
                   before, the derived key and no HPKE keys after). Exactly
                   the 3 bumped reports fail; the step's own peak device
                   bytes must stay under vdaf/feasibility.py's model; the
                   batch is collected as in phase 9 and must equal the
                   bucket counts of the 1,021 valid measurements; the armed
                   journal must not have synced;
  14. outage-drill the same task, a fresh batch of 1,024 reports: both
                   datastores' supervisors start (probe 0.2 s, down after 3
                   failures, up after 2 successes). Midway through the
                   uploads the failpoint datastore.connect.leader=error
                   takes the leader's database away: the supervisor must go
                   down, the writer spills, and every upload must still get
                   201 on the journal's fsync; the failpoint is cleared, the
                   supervisor must pass through recovering to up and the
                   replayer drain the journal exactly once (replayed fresh =
                   spilled, no duplicate, 1,024 stored). Then, inside the
                   job's first step (after the leader's device init), the
                   helper's database goes away the same way: its aggregate
                   route must shed 503 with Retry-After, the leader's
                   breaker open and its driver step back; after the helper
                   is up again the next step must complete on the card
                   (kernels 1 and 2 launched), and the collection must equal
                   the ground truth of the acknowledged valid reports. The
                   line gives the spilled and replayed counts, the journal's
                   fsyncs and peak bytes, each supervisor's transitions with
                   their times, the sheds and step-backs, the upload ack
                   latency p50/p99 during the outage and outside it, and the
                   times from each clear to up and to an empty journal.
                   Every failpoint is cleared in a finally.

Output: JSON lines (build, the profile of one draft sumvec step, the
sponge chains, one serve line per XOF mode with the seconds of each
stage of the request, one drive line per XOF mode with the seconds of
each stage of the leader's step and the helper's request in it, the
upload-drive lines with the upload, ingest, create and step seconds, and
in the drive-sumvec and upload-drive lines a "collect" record (the
seconds of create, the driver's gather, sum, http_aggregate_share and
store, the helper's handle_aggregate_share, poll and unshard, and GC,
with GC's seconds by side and by delete; the device bytes before and the
peak during the collection step), the poplar1 and drive_poplar1 lines,
the taskprov_histogram and outage_drill lines,
the kernels, one line per path, the run's wall time), then the card's
name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}.
Without CUDA, or without the package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

SEED = 20261016
VERIFY_KEY = bytes(range(32, 48))
# Poplar1<XofShake128, 16> at its leaf level, bench.py's configuration
POPLAR1_BITS = 16
POPLAR1_PREFIXES = 256
POPLAR1_BATCH = 512
POPLAR1_SEED = 0xB0B
# the taskprov path's circuit, BASELINE.json configs[3]: Prio3Histogram(10000);
# its tree leaf level and the helper's measurement share are ceil(10000 / 7)
# = 1,429 Keccak blocks a report
HIST_LENGTH = 10_000
HIST_BLOCKS = -(-HIST_LENGTH // 7)

# Least-time model of the card (H100 SXM): HBM3 at 3.35 TB/s, and the
# 32-bit integer pipe at 64 ops/clock/SM (the CUDA programming guide's
# throughput table for compute capability 9.0) x 132 SMs x 1.98 GHz, the
# clock behind the published 67 TFLOP/s fp32 rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# A Keccak-f[1600] round in the fewest 32-bit instructions, counting
# 3-input logic (LOP3) and funnel shifts: theta 80 (column parities 20,
# rotations 10, the 3-input update of 25 lanes 50), rho 48 (24 rotations),
# chi 50 (one LOP3 per half lane), iota 2.
KECCAK_OPS_PER_ROUND = 180
# One 192-bit -> Field128 reduction (csrc/expand_f128.cu f128_reduce192):
# two folds and two conditional corrections of carry-chained 32-bit adds,
# about 40 instructions.
F128_REDUCE_OPS = 40
# The two fields' moduli (the sponge kernel takes its modulus as an argument).
F64 = 2**64 - 2**32 + 1
F128 = 2**128 - 7 * 2**66 + 1


def kernel_counters():
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from janus_tpu_torch.ops import expand_cuda, keccak_cuda, scatter_cuda, sponge_cuda

    return {"keccak_single_block": keccak_cuda.keccak_single_block, "expand_f128": expand_cuda.expand_f128,
            "keccak_sponge": sponge_cuda.keccak_sponge, "scatter_rows": scatter_cuda.scatter_rows}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_cuda(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over unsigned 64-bit words (0 when identical)."""
    worst = 0
    for g, w in zip(got, want):
        if torch.equal(g, w):
            continue
        diff = g != w
        gv = g[diff].cpu().numpy().view("uint64")[:4096]
        wv = w[diff].cpu().numpy().view("uint64")[:4096]
        worst = max(worst, max(abs(int(a) - int(b)) for a, b in zip(gv, wv)))
    return worst


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build():
    from janus_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
        ptxas[name] = [
            line.strip() for line in cuda_build.build_log(name).splitlines()
            if "registers" in line or "spill" in line
        ]
    emit({"build": {"seconds": secs, "kernels": list(cuda_build.KERNELS), "ptxas": ptxas}})


def phase_kernels(torch, dev):
    """Each kernel against its plain version at main-path shapes."""
    import numpy as np

    from janus_tpu_torch.ops import expand_cuda, keccak_cuda

    rng = np.random.default_rng(SEED)

    def lanes(shape):
        a = rng.integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)
        return torch.from_numpy(a.view(np.int64)).to(dev)

    batch, blocks, length = 1024, 2286, 16000  # SumVec(1000, 16): 16000 F128 elements a report
    results = {"keccak_sponge": []}  # the path's kernel first

    # kernel 1: the leader binder's tree-digest leaf level is 1024 x 2286
    # states (out_lanes 2); counter-mode streams take out_lanes 21
    cases = []
    cols = list(lanes((21, batch, blocks)))
    n = batch * blocks
    for out_lanes, rounds in ((2, 24), (21, 24), (21, 3)):
        got = keccak_cuda.keccak_single_block(cols, out_lanes, rounds=rounds)
        want = keccak_cuda.keccak_single_block_plain(cols, out_lanes, rounds=rounds)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        ms = time_cuda(torch, lambda: keccak_cuda.keccak_single_block(cols, out_lanes, rounds=rounds), reps=10)
        plain_ms = time_cuda(torch, lambda: keccak_cuda.keccak_single_block_plain(cols, out_lanes, rounds=rounds), reps=2)
        b_ms, b_by = bound_ms(n * rounds * KECCAK_OPS_PER_ROUND, n * 8 * (21 + out_lanes))
        cases.append({"states": n, "out_lanes": out_lanes, "rounds": rounds, "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        del got, want
    del cols
    # the Poplar1 leaf walk's shape: 512 reports x 256 prefixes, 21 lanes out
    n = POPLAR1_BATCH * POPLAR1_PREFIXES
    cols = list(lanes((21, n)))
    got = keccak_cuda.keccak_single_block(cols, 21)
    want = keccak_cuda.keccak_single_block_plain(cols, 21)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    ms = time_cuda(torch, lambda: keccak_cuda.keccak_single_block(cols, 21), reps=20)
    plain_ms = time_cuda(torch, lambda: keccak_cuda.keccak_single_block_plain(cols, 21), reps=2)
    b_ms, b_by = bound_ms(n * 24 * KECCAK_OPS_PER_ROUND, n * 8 * (21 + 21))
    cases.append({"case": "poplar1 leaf walk", "states": n, "out_lanes": 21, "rounds": 24, "max_abs_err": err,
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
    del got, want, cols
    # the taskprov path's Prio3Histogram(10000): the leader binder's tree
    # leaf level, 1024 reports x ceil(10000 / 7) = 1,429 states, 2 lanes out
    n = batch * HIST_BLOCKS
    cols = list(lanes((21, batch, HIST_BLOCKS)))
    got = keccak_cuda.keccak_single_block(cols, 2)
    want = keccak_cuda.keccak_single_block_plain(cols, 2)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    ms = time_cuda(torch, lambda: keccak_cuda.keccak_single_block(cols, 2), reps=10)
    plain_ms = time_cuda(torch, lambda: keccak_cuda.keccak_single_block_plain(cols, 2), reps=2)
    b_ms, b_by = bound_ms(n * 24 * KECCAK_OPS_PER_ROUND, n * 8 * (21 + 2))
    cases.append({"case": "histogram10000 tree leaves", "states": n, "out_lanes": 2, "rounds": 24,
                  "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
    del got, want, cols
    results["keccak_single_block"] = cases

    # kernel 2: the helper measurement share, 1024 reports x 2286 blocks
    cases = []
    prefix = lanes((batch, 5))  # dst || seed || AGG1
    for offset, rounds in ((3, 24), (1, 5)):
        got = expand_cuda.expand_f128(prefix, blocks, length, block_offset=offset, rounds=rounds)
        want = expand_cuda.expand_f128_plain(prefix, blocks, length, block_offset=offset, rounds=rounds)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        ms = time_cuda(torch, lambda: expand_cuda.expand_f128(prefix, blocks, length, block_offset=offset, rounds=rounds), reps=10)
        plain_ms = time_cuda(torch, lambda: expand_cuda.expand_f128_plain(prefix, blocks, length, block_offset=offset, rounds=rounds), reps=2)
        nb = batch * blocks
        b_ms, b_by = bound_ms(
            nb * rounds * KECCAK_OPS_PER_ROUND + batch * length * F128_REDUCE_OPS,
            prefix.numel() * 8 + 2 * batch * length * 8,
        )
        cases.append({"reports": batch, "blocks": blocks, "length": length, "block_offset": offset,
                      "rounds": rounds, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by})
        del got, want
    # the streamed helper's tile at SumVec(100000, 16): 128 reports, one
    # step's 8,848 blocks (61,936 elements) at the last step's block offset
    tb, tblocks, tlen, toff = 128, 8848, 61936, 25 * 8848
    tprefix = lanes((tb, 5))
    got = expand_cuda.expand_f128(tprefix, tblocks, tlen, block_offset=toff)
    want = expand_cuda.expand_f128_plain(tprefix, tblocks, tlen, block_offset=toff)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    del got, want
    ms = time_cuda(torch, lambda: expand_cuda.expand_f128(tprefix, tblocks, tlen, block_offset=toff), reps=10)
    plain_ms = time_cuda(torch, lambda: expand_cuda.expand_f128_plain(tprefix, tblocks, tlen, block_offset=toff), reps=2)
    b_ms, b_by = bound_ms(tb * tblocks * 24 * KECCAK_OPS_PER_ROUND + tb * tlen * F128_REDUCE_OPS,
                          tprefix.numel() * 8 + 2 * tb * tlen * 8)
    cases.append({"case": "stream tile", "reports": tb, "blocks": tblocks, "length": tlen, "block_offset": toff,
                  "rounds": 24, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                  "bound_by": b_by})
    del tprefix
    # the taskprov path's Prio3Histogram(10000): the helper's measurement
    # share, 1024 reports x 1,429 blocks, 10,000 elements
    hlen = HIST_LENGTH
    got = expand_cuda.expand_f128(prefix, HIST_BLOCKS, hlen)
    want = expand_cuda.expand_f128_plain(prefix, HIST_BLOCKS, hlen)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    del got, want
    ms = time_cuda(torch, lambda: expand_cuda.expand_f128(prefix, HIST_BLOCKS, hlen), reps=10)
    plain_ms = time_cuda(torch, lambda: expand_cuda.expand_f128_plain(prefix, HIST_BLOCKS, hlen), reps=2)
    b_ms, b_by = bound_ms(batch * HIST_BLOCKS * 24 * KECCAK_OPS_PER_ROUND + batch * hlen * F128_REDUCE_OPS,
                          prefix.numel() * 8 + 2 * batch * hlen * 8)
    cases.append({"case": "histogram10000 helper share", "reports": batch, "blocks": HIST_BLOCKS, "length": hlen,
                  "block_offset": 0, "rounds": 24, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": b_ms, "bound_by": b_by})
    results["expand_f128"] = cases
    del prefix

    # kernel 3: whole draft XOF calls, one launch each. (name, batch, head
    # bytes, body elements, body limbs, mode, rounds), mode an out_lanes
    # count or a (length, limbs, modulus) sample; F128/F64 the fields' p
    cases = []
    for name, n, head_bytes, elems, limbs, mode, rounds in (
        ("joint-rand part, full", 1024, 42, length, 2, 2, 3),
        ("F128 sample of 16000", 1024, 26, 0, 0, (length, 2, F128), 3),
        ("joint-rand part, 38 blocks", 1024, 42, 400, 2, 2, 24),
        ("F128 sample of 350", 1024, 26, 0, 0, (350, 2, F128), 24),
        ("F64 sample of 1000", 8192, 26, 0, 0, (1000, 1, F64), 24),
        ("F128 sample, half rejected", 1024, 26, 0, 0, (400, 2, 2**127), 24),
        ("F64 sample, half rejected", 1024, 26, 0, 0, (400, 1, 2**63), 24),
        ("F128 sample, 1/32 rejected", 1024, 42, 40, 2, (300, 2, 2**128 - 2**123), 24),
    ):
        head, msg_len, body = sponge_inputs(lanes, n, head_bytes, elems, limbs)
        cases.append({"case": name, "states": n, "msg_bytes": msg_len, "rounds": rounds,
                      "mode": mode if isinstance(mode, int) else list(mode[:2]),
                      **check_sponge(torch, head, msg_len, body, head_bytes, mode, rounds)})
        del head, body
    cases.append(check_long_absorb(torch, dev))
    results["keccak_sponge"] = cases
    results["scatter_rows"] = check_scatter(torch, dev, rng)
    bad = [c for cs in results.values() for c in cs if c["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return results


def sponge_inputs(lanes, n: int, head_bytes: int, elems: int, limbs: int):
    """A random head of head_bytes bytes ([n, h] lanes, zero past its end)
    and a body of `limbs` random limb planes [n, elems] right after it."""
    head = lanes((n, -(-head_bytes // 8)))
    if head_bytes % 8:
        head[:, -1] &= (1 << (8 * (head_bytes % 8))) - 1
    body = tuple(lanes((n, elems)) for _ in range(limbs))
    return head, head_bytes + 8 * elems * limbs, body


def sponge_permutations(torch, msg_len: int, stream, mode) -> int:
    """Permutations a call needs over all reports: the absorbed blocks,
    and in sampling the squeezed blocks up to the one where the output
    filled or the window ran out (from the plain stream, per report)."""
    from janus_tpu_torch.fields.tfield import i64, ult
    from janus_tpu_torch.ops.sponge_cuda import REJECT_WINDOW, candidate_count

    n = stream.shape[0]
    absorbed = msg_len // 168 + 1
    if isinstance(mode, int):
        return n * absorbed
    length, limbs, modulus = mode
    c = [stream[:, j : candidate_count(length) * limbs : limbs] for j in range(limbs)]
    if limbs == 1:
        accept = ult(c[0], i64(modulus))
    else:
        p_lo, p_hi = i64(modulus & (2**64 - 1)), i64(modulus >> 64)
        accept = ult(c[1], p_hi) | ((c[1] == p_hi) & ult(c[0], p_lo))
    stop = (torch.cumsum(accept.long(), 1) >= length) | (torch.cumsum((~accept).long(), 1) > REJECT_WINDOW)
    consumed = (stop.int().argmax(dim=1) + 1) * limbs  # stream lanes read
    squeezed = (consumed + 20) // 21
    return int((absorbed + squeezed - 1).sum())


def check_sponge(torch, head, msg_len: int, body, body_off: int, mode, rounds: int):
    """The sponge kernel against its plain version, piece by piece (the
    plain time is the sum of the pieces'), with the bound of this call."""
    from janus_tpu_torch.ops import sponge_cuda as sc

    kw = {"out_lanes": mode} if isinstance(mode, int) else {"sample": mode}
    got = sc.keccak_sponge(head, msg_len, body, body_off, rounds=rounds, **kw)
    got = (got,) if isinstance(mode, int) else got
    n = head.shape[0]
    out_blocks = 1 if isinstance(mode, int) else sc.stream_blocks(mode[0], mode[1])
    plain = {}
    msg = time_once(torch, plain, "message", lambda: sc.sponge_message(head, msg_len, body, body_off))
    stream = time_once(torch, plain, "squeeze", lambda: sc.sponge_squeeze_plain(msg, out_blocks, rounds))
    stream = stream.reshape(n, -1)
    del msg
    if isinstance(mode, int):
        want = (stream[:, :mode],)
    else:
        want = time_once(torch, plain, "sample", lambda: sc.reject_sample_scan(stream, *mode))
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    perms = sponge_permutations(torch, msg_len, stream, mode)
    del stream, want
    ms = time_cuda(torch, lambda: sc.keccak_sponge(head, msg_len, body, body_off, rounds=rounds, **kw), reps=5)
    out_words = n * (mode if isinstance(mode, int) else mode[0] * mode[1])
    in_bytes = head.numel() * 8 + sum(p.numel() * 8 for p in body)
    b_ms, b_by = bound_ms(perms * rounds * KECCAK_OPS_PER_ROUND, in_bytes + out_words * 8)
    return {"permutations": perms, "max_abs_err": err, "ms": ms, "plain_ms": sum(plain.values()),
            "plain_ms_by_piece": plain, "bound_ms": b_ms, "bound_by": b_by}


def check_long_absorb(torch, dev, n: int = 64, elems: int = 1_600_000, head_bytes: int = 42, held: int = 4):
    """Kernel 3 at draft SumVec(100000, 16)'s joint-rand part: a
    25,600,042-byte message a report (152,382 absorbed blocks), 64
    reports, 24 rounds, a 16-byte seed out. Its plain version is a
    per-block loop of eager ops, hours at this length: the case is held
    instead against hashlib.shake_128 of the same message on `held`
    reports (at 24 rounds the draft sponge is SHAKE128), and its
    plain_ms is null."""
    import hashlib

    import numpy as np

    from janus_tpu_torch.ops import sponge_cuda as sc

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def device_lanes(shape):  # 1.6 GB of body: drawn on the card, 63 random bits a lane
        return torch.empty(shape, dtype=torch.int64, device=dev).random_(generator=gen)

    head, msg_len, body = sponge_inputs(device_lanes, n, head_bytes, elems, 2)
    got = sc.keccak_sponge(head, msg_len, body, head_bytes, out_lanes=2)
    torch.cuda.synchronize()
    host_head = head[:held].cpu().numpy()
    host_body = [p[:held].cpu().numpy() for p in body]
    worst = 0
    for i in range(held):
        msg = host_head[i].astype("<u8").tobytes()[:head_bytes]
        msg += np.stack([host_body[0][i], host_body[1][i]], axis=-1).astype("<u8").tobytes()
        assert len(msg) == msg_len
        want = np.frombuffer(hashlib.shake_128(msg).digest(16), dtype="<u8")
        row = got[i].cpu().numpy().view(np.uint64)
        worst = max(worst, max(abs(int(a) - int(b)) for a, b in zip(row, want)))
    del host_head, host_body
    ms = time_cuda(torch, lambda: sc.keccak_sponge(head, msg_len, body, head_bytes, out_lanes=2), reps=1, warmup=0)
    perms = n * (msg_len // 168 + 1)
    b_ms, b_by = bound_ms(perms * 24 * KECCAK_OPS_PER_ROUND, head.numel() * 8 + n * elems * 16 + n * 16)
    del head, body, got
    return {"case": "joint-rand part, SumVec(100000, 16)", "states": n, "msg_bytes": msg_len, "rounds": 24,
            "mode": 2, "permutations": perms, "held_against": f"hashlib.shake_128 on {held} reports",
            "max_abs_err": worst, "ms": ms, "plain_ms": None, "bound_ms": b_ms, "bound_by": b_by}


class MethodSeconds:
    """While open, sums the host seconds spent in the named methods of
    `cls` (from any thread) into `seconds`, each under its name."""

    def __init__(self, cls, names):
        import threading

        self.cls, self.names = cls, names
        self.seconds = {n: 0.0 for n in names}
        self._lock = threading.Lock()

    def __enter__(self):
        # the class's own entries (a classmethod's descriptor, not the
        # bound method), put back as they were; None for an inherited one
        self._saved = {n: self.cls.__dict__.get(n) for n in self.names}
        for n in self.names:
            setattr(self.cls, n, self._timed(n, getattr(self.cls, n)))
        return self.seconds

    def __exit__(self, *exc):
        for n, raw in self._saved.items():
            if raw is None:
                delattr(self.cls, n)
            else:
                setattr(self.cls, n, raw)

    def _timed(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with self._lock:
                    self.seconds[name] += time.perf_counter() - t0

        return timed


def time_once(torch, into: dict, key: str, fn):
    """fn() once, its milliseconds on the card recorded under `key`."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    into[key] = start.elapsed_time(end)
    return out


def phase_sponge(torch, dev):
    """Wall time of the draft sponge's two long chains at batch 1024, as
    the draft-sumvec step runs them, at 24 rounds: a joint-rand part (a
    256,042-byte message, 1,525 absorbed blocks) and a measurement share
    (one absorbed block, then squeezed blocks until 16,000 Field128
    elements are drawn: 1,524 without a reject), one kernel launch each,
    with the bound of each chain."""
    import numpy as np

    from janus_tpu_torch.ops import sponge_cuda as sc

    rng = np.random.default_rng(SEED + 2)

    def lanes(shape):
        a = rng.integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)
        return torch.from_numpy(a.view(np.int64)).to(dev)

    out = {}
    for name, head_bytes, elems, mode in (("absorb", 42, 16000, 2), ("squeeze", 26, 0, (16000, 2, F128))):
        head, msg_len, body = sponge_inputs(lanes, 1024, head_bytes, elems, 2 if elems else 0)
        kw = {"out_lanes": mode} if isinstance(mode, int) else {"sample": mode}
        sc.keccak_sponge(head, msg_len, body, head_bytes, **kw)  # warm-up
        torch.cuda.synchronize()
        sc.keccak_sponge.launches = 0
        t0 = time.perf_counter()
        sc.keccak_sponge(head, msg_len, body, head_bytes, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if sc.keccak_sponge.launches != 1:
            raise AssertionError(f"{name} chain: {sc.keccak_sponge.launches} launches")
        # permutations a report: the absorbed blocks, plus in sampling the
        # squeezed blocks that 16,000 Field128 candidates fill (Field128
        # rejects a candidate with probability 2^-68)
        perms = msg_len // 168 + 1 + (0 if isinstance(mode, int) else -(-16000 * 2 // 21) - 1)
        out_bytes = 8 * mode if isinstance(mode, int) else 8 * 16000 * 2
        b_ms, b_by = bound_ms(1024 * perms * 24 * KECCAK_OPS_PER_ROUND, 1024 * (msg_len + out_bytes))
        out[name] = {"launches": 1, "permutations": perms, "s": secs, "us_per_permutation": secs / perms * 1e6,
                     "bound_ms": b_ms, "bound_by": b_by}
    return out


def _bump_rows(torch, p3, field, rows):
    """A copy of `field` with element 0 of each listed report plus 1 (mod p)."""
    from janus_tpu_torch.fields.tfield import fconst

    out = tuple(x.clone() for x in field)
    idx = torch.tensor(rows, device=out[0].device)
    sel = tuple(x[idx, :1] for x in out)
    new = p3.tf.add(sel, fconst(p3.tf, 1, (), out[0].device))
    for x, v in zip(out, new):
        x[idx, :1] = v
    return out

def sparse_measurements(inst, batch: int, seed: int):
    """`batch` measurements of a sparse_sumvec `inst`: 1..max_blocks blocks
    a report, uniform over the logical blocks, block 0 (the hot block) in
    every one, values uniform over [0, 2^bits). Returns (the measurements
    as (block, values) pairs, [batch, max_blocks] int32 block indices with
    -1 padding, [batch, compact_len] int64 compact values), from numpy's
    generator at `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mb, bs = inst.max_blocks, inst.block_size
    n_blocks = inst.length // bs
    meas = []
    block_idx = np.full((batch, mb), -1, dtype=np.int32)
    compact = np.zeros((batch, mb * bs), dtype=np.int64)
    for i in range(batch):
        nb = int(rng.integers(1, mb + 1))
        blocks = [0] + sorted((1 + rng.choice(n_blocks - 1, size=nb - 1, replace=False)).tolist())
        vals = rng.integers(0, 1 << inst.bits, size=(nb, bs))
        meas.append([(b, v.tolist()) for b, v in zip(blocks, vals)])
        block_idx[i, :nb] = blocks
        compact[i, : nb * bs] = vals.reshape(-1)
    return meas, block_idx, compact


def sparse_truth(length: int, flat, compact, rows) -> list:
    """The logical sum of the listed reports' compact values at their flat
    positions (numpy's scatter-add; the sentinel `length` drops a lane)."""
    import numpy as np

    f, v = flat[rows].reshape(-1), compact[rows].reshape(-1)
    live = f < length
    out = np.zeros(length, dtype=np.int64)
    np.add.at(out, f[live], v[live])
    return [int(x) for x in out]


def check_scatter(torch, dev, rng):
    """Kernel 4 against its plain version on the card: the north star (1,024
    reports x 1,024 compact lanes into 1,000,000 positions, blocks uniform
    over 15,625 with block 0 in every report), then a 64-row bucket with 3
    rejected rows and 24 padding rows (all sentinel)."""
    import numpy as np

    from janus_tpu_torch.ops import scatter_cuda
    from janus_tpu_torch.vdaf.registry import VdafInstance, circuit_for
    from janus_tpu_torch.vdaf.wire import flat_scatter_indices

    inst = VdafInstance.sparse_sumvec(16, 1_000_000, 64, 16)
    circ = circuit_for(inst)
    L = circ.logical_length
    cases = []
    for name, b, dead in (("north star, hot block 0", 1024, ()), ("rejected and padding rows", 64, (3, 17, 30, *range(40, 64)))):
        _, bi, _ = sparse_measurements(inst, b, int(rng.integers(0, 2**31)))
        bi[list(dead)] = -1
        flat = flat_scatter_indices(bi, circ)
        idx = torch.from_numpy(flat).to(dev)
        lo = rng.integers(0, 2**64 - 1, size=flat.shape, dtype=np.uint64, endpoint=True)
        hi = rng.integers(0, (F128 >> 64) - 1, size=flat.shape, dtype=np.uint64)  # reduced: below p's high word
        vals = tuple(torch.from_numpy(a.view(np.int64)).to(dev) for a in (lo, hi))
        acc = tuple(torch.from_numpy(rng.integers(0, (F128 >> 64) - 1, size=L, dtype=np.uint64).view(np.int64)).to(dev)
                    for _ in range(2))
        got = scatter_cuda.scatter_rows(acc, vals, idx)
        want = scatter_cuda.scatter_rows_plain(acc, vals, idx)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        ms = time_cuda(torch, lambda: scatter_cuda.scatter_rows(acc, vals, idx), reps=20)
        plain_ms = time_cuda(torch, lambda: scatter_cuda.scatter_rows_plain(acc, vals, idx), reps=1, warmup=0)
        live = int((flat < L).sum())
        # bytes: live values and every index read once, acc read once and
        # written once; operations: one Field128 add (8 32-bit ops) a live lane
        b_ms, b_by = bound_ms(8 * live, live * 16 + flat.size * 4 + 2 * L * 16)
        cases.append({"case": name, "reports": b, "compact_lanes": flat.shape[1], "logical_length": L,
                      "live_lanes": live, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by})
        del got, want, vals, acc, idx
    return cases


def phase_sparse(torch, dev, inst, batch: int, bad_rows, reps: int = 2, small_batch: int = 4):
    """Block-sparse SumVec at full width (see the module docstring, phase
    6d): the two-party step over the compact encoding, then each party's
    prepare on the engine and aggregate_sparse into the logical vector;
    returns the record."""
    import numpy as np

    from janus_tpu_torch.aggregator.engine_cache import DeviceRowsChunks, EngineCache
    from janus_tpu_torch.parallel import api
    from janus_tpu_torch.vdaf.feasibility import prepare_row_bytes, sparse_aggregate_bytes
    from janus_tpu_torch.vdaf.registry import prio3_batched
    from janus_tpu_torch.vdaf.testing import make_report_batch
    from janus_tpu_torch.vdaf.wire import decode_index_columns, encode_block_indices, flat_scatter_indices

    counters = kernel_counters()
    p3 = prio3_batched(inst, dev)
    circ = p3.circ
    L = circ.logical_length
    t0 = time.perf_counter()
    meas, block_idx, compact = sparse_measurements(inst, batch, SEED + 21)
    gen_s = time.perf_counter() - t0
    # one report's indices made descending on the wire: the predicate must
    # refuse that row alone (its proof is valid)
    bad_index = next(i for i in range(batch // 2, batch) if block_idx[i, 1] >= 0 and i not in bad_rows)
    blobs = [encode_block_indices(row) for row in block_idx]
    blob = bytearray(blobs[bad_index])
    blob[0:4], blob[4:8] = blob[4:8], blob[0:4]
    blobs[bad_index] = bytes(blob)
    t0 = time.perf_counter()
    dec_idx, idx_ok = decode_index_columns(blobs, circ)
    flat = flat_scatter_indices(dec_idx, circ)
    index_s = time.perf_counter() - t0
    if np.flatnonzero(~idx_ok).tolist() != [bad_index]:
        raise AssertionError(f"sparse: the index predicate refused {np.flatnonzero(~idx_ok).tolist()}")

    t0 = time.perf_counter()
    args, _ = make_report_batch(inst, meas, seed=SEED + 21, shard_chunk=256, device=dev)
    _sync(torch, dev)
    shard_s = time.perf_counter() - t0
    args = list(args)
    args[3] = _bump_rows(torch, p3, args[3], bad_rows)  # corrupt leader proof shares
    step = api.two_party_step(inst, VERIFY_KEY, device=dev)
    eng = EngineCache(inst, VERIFY_KEY, device=dev)

    def engine_step():
        out0, _, ver0, part0 = eng.leader_init(*args[:5])
        out1, accept, _ = eng.helper_init(args[0], args[1], args[5], args[6], ver0, part0, idx_ok)
        # one scatter a dispatch: a chunk of a pipelined leader's rows, or
        # a whole bucket
        dispatches = sum(len(o.chunks) if isinstance(o, DeviceRowsChunks) else 1 for o in (out0, out1))
        return accept, [eng.aggregate_sparse(out, accept, flat) for out in (out0, out1)], dispatches

    # the main path: counts at 0 just before, read just after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    agg0, agg1, count = step(*args)
    _sync(torch, dev)
    first_step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    accept, shares, dispatches = engine_step()
    first_sparse_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}

    flp_valid = np.ones(batch, dtype=bool)
    flp_valid[list(bad_rows)] = False
    if int(count) != batch - len(bad_rows):
        raise AssertionError(f"sparse: count {int(count)} != {batch - len(bad_rows)}")
    compact_total = [int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))]
    if compact_total != [int(x) for x in compact[flp_valid].sum(axis=0)]:
        raise AssertionError("sparse: the compact aggregate != numpy sum of the valid compact rows")
    valid = flp_valid & idx_ok
    if not np.array_equal(accept, valid):
        raise AssertionError(f"sparse: accepted {int(accept.sum())}, not the {int(valid.sum())} valid reports")
    total = [(a + b) % F128 for a, b in zip(*shares)]
    truth = sparse_truth(L, flat, compact, np.flatnonzero(valid))
    if len(total) != L or total != truth:
        raise AssertionError("sparse: leader + helper logical shares != numpy scatter-sum of the valid reports")
    _check_launches(torch, dev, "sparse", launches, kernels=("keccak_single_block", "expand_f128", "scatter_rows"))
    if _on_card(torch, dev) and launches["scatter_rows"] != dispatches:
        raise AssertionError(f"sparse: the scatter launched {launches['scatter_rows']} times, not {dispatches}")

    # a small batch agrees with the plain path on the CPU
    small = []
    for d in (dev, "cpu"):
        sargs, _ = make_report_batch(inst, meas[:small_batch], seed=SEED + 22, device=d)
        se = EngineCache(inst, VERIFY_KEY, device=d)
        o0, _, v0, q0 = se.leader_init(*sargs[:5])
        o1, acc_small, _ = se.helper_init(sargs[0], sargs[1], sargs[5], sargs[6], v0, q0, np.ones(small_batch, bool))
        small.append([se.aggregate_sparse(o, acc_small, flat[:small_batch]) for o in (o0, o1)])
    if small[0] != small[1]:
        raise AssertionError("sparse small batch: card and CPU plain path disagree")
    if [(a + b) % F128 for a, b in zip(*small[0])] != sparse_truth(L, flat, compact, np.arange(small_batch)):
        raise AssertionError("sparse small batch: aggregate != numpy scatter-sum")

    # timing, and the engine step's own peak beside the model
    two_s, sparse_s, agg_s = [], [], []
    for _ in range(reps):
        t = time.perf_counter()
        step(*args)
        _sync(torch, dev)
        two_s.append(time.perf_counter() - t)
    before = _peak_reset(torch, dev)
    for _ in range(reps):
        t = time.perf_counter()
        engine_step()
        _sync(torch, dev)
        sparse_s.append(time.perf_counter() - t)
    peak = _peak(torch, dev)
    # one party's aggregate_sparse alone (host clock: the scatters, the
    # fetch of the logical vector and its int conversion)
    out0 = eng.leader_init(*args[:5])[0]
    for _ in range(reps):
        t = time.perf_counter()
        eng.aggregate_sparse(out0, valid, flat)
        agg_s.append(time.perf_counter() - t)
    del out0
    step_peak = peak - before + batch * (circ.input_len + circ.proof_len) * circ.FIELD.ENCODED_SIZE
    model = max(batch * prepare_row_bytes(circ), sparse_aggregate_bytes(circ, batch))
    return {
        "path": "sparse",
        "vdaf": inst.to_dict(),
        "batch": batch,
        "corrupted": len(bad_rows),
        "bad_index_row": bad_index,
        "count": int(count),
        "accepted": int(accept.sum()),
        "aggregate_ok": True,
        "logical_length": L,
        "compact_lanes": circ.output_len,
        "live_lanes": int((flat[valid] < L).sum()),
        "block0_reports": int((block_idx[:, 0] == 0).sum()),
        "small_batch_matches_cpu": small_batch,
        "launches": launches,
        "scatter_dispatches": dispatches,
        "measurements_s": gen_s,
        "index_predicate_s": index_s,
        "shard_s": shard_s,
        "first_step_s": first_step_s,
        "first_sparse_step_s": first_sparse_s,
        "two_party_step_s": two_s,
        "sparse_step_s": sparse_s,
        "sparse_reports_per_s": batch / (sum(sparse_s) / len(sparse_s)),
        "aggregate_sparse_s": agg_s,
        "allocated_before_step_bytes": before,
        "peak_device_bytes": peak,
        "step_peak_bytes": step_peak,
        "model_peak_bytes": model,
        "within_model": step_peak <= model,
    }


def run_path(torch, dev, name: str, inst, batch: int, bad_rows, kernels, reps: int, shard_chunk: int,
             small_batch: int, small_rounds: int = 24, plan=None, identity_batch: int = 0,
             small_shard_on_card: bool = False):
    """Drive one path through the entry points; returns (its JSON record,
    (the step function, its arguments)). `kernels` must launch during the
    step, every other kernel must not. The small batch held against the
    CPU runs at `small_rounds` Keccak rounds on both sides (none when
    small_batch is 0); with `small_shard_on_card` it is sharded once, on
    the card, and both devices prepare those reports (the CPU prover of a
    long vector takes minutes). `plan`: the engine's stream plan must be this
    (tile, gcalls, n_steps), and then `identity_batch` reports are
    prepared on the card by the streamed and by the whole-share route,
    which must agree element for element, and each route's peak device
    bytes must lie within the memory model's (vdaf/feasibility.py)."""
    import numpy as np

    from janus_tpu_torch.parallel import api
    from janus_tpu_torch.vdaf import keccak
    from janus_tpu_torch.vdaf.feasibility import prepare_row_bytes
    from janus_tpu_torch.vdaf.registry import prio3_batched
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    counters = kernel_counters()
    p3 = prio3_batched(inst, dev)
    circ = p3.circ
    draft = inst.xof_mode != "fast"
    got_plan = None if p3.plan is None else (p3.plan.group, p3.plan.gcalls, p3.plan.n_steps)
    if got_plan != plan:
        raise AssertionError(f"{name}: stream plan {got_plan}, want {plan}")
    # the aggregate of valid measurements: their sum (FixedPointVec's is
    # offset binary, each entry plus 2^(bits-1))
    offset = getattr(circ, "offset", 0)

    def truth(m):
        return [int(x) for x in (np.asarray(m, dtype=np.int64) + offset).sum(axis=0).reshape(-1)]

    meas = random_measurements(inst, batch, np.random.default_rng(SEED))
    t0 = time.perf_counter()
    args, _ = make_report_batch(inst, meas, seed=SEED, shard_chunk=shard_chunk, device=dev)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    args = list(args)
    args[3] = _bump_rows(torch, p3, args[3], bad_rows)  # corrupt leader proof shares
    step = api.two_party_step(inst, VERIFY_KEY, device=dev)

    # the main path: counts at 0 just before, read just after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    agg0, agg1, count = step(*args)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    valid = np.ones(batch, dtype=bool)
    valid[list(bad_rows)] = False
    total = [int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))]
    if int(count) != batch - len(bad_rows):
        raise AssertionError(f"count {int(count)} != {batch - len(bad_rows)}")
    if total != truth(np.asarray(meas)[valid]):
        raise AssertionError("aggregate != numpy sum of the valid measurements")
    decoded_ok = None
    if offset:
        want = [float(x) / offset for x in np.asarray(meas)[valid].sum(axis=0)]
        decoded_ok = circ.decode(total, int(count)) == want
        if not decoded_ok:
            raise AssertionError("the aggregate does not decode to the float sum")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {name} path: {missing} ({launches})")
    stray = [k for k in counters if k not in kernels and launches[k] != 0]
    if stray:
        raise AssertionError(f"kernels of another path launched on the {name} path: {stray} ({launches})")

    # a small batch agrees with the plain path on the CPU
    if small_batch:
        small = meas[:small_batch]
        outs = []
        full_rounds = keccak.KECCAK_ROUNDS
        keccak.KECCAK_ROUNDS = small_rounds
        try:
            if small_shard_on_card:
                card_args, _ = make_report_batch(inst, small, seed=SEED + 1, device=dev)
            for d in (dev, "cpu"):
                if small_shard_on_card:
                    sargs = [None if a is None else (tuple(x.to(d) for x in a) if isinstance(a, tuple) else a.to(d))
                             for a in card_args]
                else:
                    sargs, _ = make_report_batch(inst, small, seed=SEED + 1, device=d)
                s0, s1, sc = api.two_party_step(inst, VERIFY_KEY, device=d)(*sargs)
                sp3 = prio3_batched(inst, d)
                outs.append(([int(x) for x in sp3.tf.to_ints(sp3.merge_agg_shares(s0, s1))], int(sc)))
        finally:
            keccak.KECCAK_ROUNDS = full_rounds
        if outs[0] != outs[1]:
            raise AssertionError("small batch: card and CPU plain path disagree")
        if outs[0] != (truth(small), small_batch):
            raise AssertionError("small batch: aggregate != numpy sum")

    identity = None
    if identity_batch:
        identity = check_routes_agree(torch, p3, args, identity_batch, draft)

    # timing: the main-path step above warmed both steps' shapes; the
    # peak is read over the last two-party run
    helper = api.helper_init_step(inst, VERIFY_KEY, device=dev)
    hargs = (args[0], args[1], args[5], args[6])

    def timed(fn, fargs):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn(*fargs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return times

    helper_s = timed(helper, hargs)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    two_s = timed(step, args)
    peak = torch.cuda.max_memory_allocated()
    # the step's own peak: what it adds to the card, plus the staged
    # leader shares and proofs of its reports (the model counts them;
    # whatever else was allocated before is not the step's)
    step_peak = peak - before + batch * (circ.input_len + circ.proof_len) * circ.FIELD.ENCODED_SIZE
    model = batch * prepare_row_bytes(circ, tile_elems=p3.plan.group if p3.plan else None, draft=draft)
    if plan is not None and step_peak > model:
        raise AssertionError(f"{name}: the step's peak {step_peak} bytes past the memory model's {model}")
    rec = {
        "path": name,
        "vdaf": inst.to_dict(),
        "batch": batch,
        "corrupted": len(bad_rows),
        "count": int(count),
        "aggregate_ok": True,
        "small_batch_matches_cpu": bool(small_batch),
        "small_batch_rounds": small_rounds if small_batch else None,
        "launches": launches,
        "shard_s": shard_s,
        "first_step_s": first_step_s,
        "two_party_step_s": two_s,
        "two_party_reports_per_s": batch / (sum(two_s) / len(two_s)),
        "helper_init_step_s": helper_s,
        "helper_init_reports_per_s": batch / (sum(helper_s) / len(helper_s)),
        "allocated_before_step_bytes": before,
        "peak_device_bytes": peak,
        "step_peak_bytes": step_peak,
        "model_peak_bytes": model,
    }
    if decoded_ok is not None:
        rec["decodes_to_float_sum"] = decoded_ok
    if plan is not None:
        rec["stream_plan"] = {"tile_elems": plan[0], "gcalls": plan[1], "n_steps": plan[2]}
        rec["routes_agree"] = identity
    return rec, (step, args)


def check_routes_agree(torch, p3, args, k: int, draft: bool):
    """The first k reports of `args` prepared on the card by `p3`'s
    streamed route and by a twin engine whose stream_plan is None (its
    threshold set past input_len): every output of both sides must be
    equal. Returns each route's seconds and its peak device bytes beside
    the model's, which they must not pass. The k rows are views of the
    batch on the card, so the peak is taken over what the step adds, and
    the k rows' staged leader share and proof are added back."""
    from janus_tpu_torch.vdaf.engine import stream_plan
    from janus_tpu_torch.vdaf.feasibility import prepare_row_bytes

    circ = p3.circ
    whole = type(p3)(circ, device=p3.device)
    whole.plan = stream_plan(whole.bc, min_input_len=circ.input_len + 1)
    assert whole.plan is None and p3.plan is not None
    nonce, parts, meas, proof, blind0, seed, blind1 = (
        None if a is None else (tuple(x[:k] for x in a) if isinstance(a, tuple) else a[:k]) for a in args
    )
    held = k * (circ.input_len + circ.proof_len) * circ.FIELD.ENCODED_SIZE
    out, rec = {}, {}
    for route, eng in (("streamed", p3), ("whole_share", whole)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        helper = eng.prepare_init_helper(VERIFY_KEY, nonce, parts, seed, blind1)
        leader = eng.prepare_init_leader(VERIFY_KEY, nonce, parts, meas, proof, blind0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before + held
        model = k * prepare_row_bytes(circ, tile_elems=eng.plan.group if eng.plan else None, draft=draft)
        if peak > model:
            raise AssertionError(f"{route} route at {k} reports: peak {peak} bytes past the model's {model}")
        out[route] = (helper, leader)
        rec[route] = {"s": secs, "peak_bytes": peak, "model_peak_bytes": model}
    for side, (a, b) in enumerate(zip(out["streamed"], out["whole_share"])):
        for name, x, y in zip(("out share", "corrected seed", "verifier", "joint-rand part"), a, b):
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            if x is None or y is None:
                same = x is None and y is None
            else:
                same = len(xs) == len(ys) and all(torch.equal(u, v) for u, v in zip(xs, ys))
            if not same:
                raise AssertionError(f"{('helper', 'leader')[side]} {name}: streamed != whole share")
    return {"reports": k, **rec}


def _bump_host_rows(field_np, rows, modulus: int):
    """A copy of a host limb tuple with element 0 of each listed report
    plus 1 (mod p)."""
    import numpy as np

    out = tuple(x.copy() for x in field_np)
    for row in rows:
        v = (sum(int(x[row, 0]) << (64 * i) for i, x in enumerate(out)) + 1) % modulus
        for i, y in enumerate(out):
            y[row, 0] = np.uint64((v >> (64 * i)) & (2**64 - 1))
    return out


def phase_serve(torch, dev, name: str, inst, batch: int, bad_rows, kernels, shard_chunk: int = 256,
                streamed: bool = False, reps: int = 2):
    """A helper answers one aggregate-init request for `inst` at `batch`
    (see the module docstring, phase 8); returns its serve record.
    `streamed`: the helper's engine must run the streamed query. `reps`:
    the leader_init routes and the helper_init seams are each timed this
    many times, in turns."""
    import numpy as np

    from janus_tpu_torch.aggregator.core import Aggregator
    from janus_tpu_torch.aggregator.engine_cache import engine_cache
    from janus_tpu_torch.aggregator.testing import leader_init_request, outcomes
    from janus_tpu_torch.convert import from_numpy_u64, step_args_to_numpy
    from janus_tpu_torch.core import hpke_backend
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.messages import AggregationJobId, PrepareError, Role, Time
    from janus_tpu_torch.parallel import api
    from janus_tpu_torch.task import QueryTypeConfig, Task, TaskBuilder
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    now = 1_700_000_000
    unknown, expired = 11, 12
    counters = kernel_counters()
    built = TaskBuilder(QueryTypeConfig.time_interval(), inst, Role.HELPER).with_(
        vdaf_verify_key=VERIFY_KEY, task_expiration=Time(now)
    ).build()
    task = Task.from_dict(built.to_dict())  # the helper is provisioned from the task's dict
    eds = EphemeralDatastore(MockClock(Time(now)))
    try:
        eds.datastore.run_tx(lambda tx: tx.put_task(task))
        helper = Aggregator(eds.datastore, eds.clock, device=dev)

        # the leader's side: shard, corrupt 3 leader shares, build the request
        engine = engine_cache(inst, VERIFY_KEY, dev)
        if (engine.p3.plan is not None) != streamed:
            raise AssertionError(f"serve {name}: stream plan {engine.p3.plan}")
        meas = random_measurements(inst, batch, np.random.default_rng(SEED + 3))
        t0 = time.perf_counter()
        args, _ = make_report_batch(inst, meas, seed=SEED + 3, shard_chunk=shard_chunk, device=dev)
        args = list(step_args_to_numpy(args))
        shard_s = time.perf_counter() - t0
        args[2] = _bump_host_rows(args[2], bad_rows, engine.p3.tf.MODULUS)
        times = [now - 100] * batch
        times[expired] = now + 50
        t0 = time.perf_counter()
        job = leader_init_request(task, engine, args, times, unknown_config=(unknown,))
        request_build_s = time.perf_counter() - t0

        # leader_init by both routes, from host columns, after the one above
        routes = {}
        pipelined_chunk = min(engine.PIPELINE_CHUNK, batch // 2)
        order = (("pipelined", pipelined_chunk), ("direct", batch), ("direct", batch), ("pipelined", pipelined_chunk))
        for route, chunk in order[: 2 * reps]:
            engine.PIPELINE_CHUNK = chunk
            t0 = time.perf_counter()
            out0, _, ver0, part0 = engine.leader_init(*args[:5])
            torch.cuda.synchronize()
            routes.setdefault(route, []).append(time.perf_counter() - t0)
            want_type = "DeviceRowsChunks" if route == "pipelined" else "DeviceRows"
            if type(out0).__name__ != want_type:
                raise AssertionError(f"leader_init took another route than {route}: {type(out0).__name__}")
            del out0
        del engine.PIPELINE_CHUNK  # back to the class's

        # the helper's request: counts at 0 just before, read just after
        job_id = AggregationJobId(bytes(range(16)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        resp = helper.handle_aggregate_init(task.task_id, job_id, job.request)
        request_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        stages = dict(helper.task_aggregator_for(task.task_id).stage_seconds)

        missing = [k for k in kernels if launches[k] == 0]
        stray = [k for k in counters if k not in kernels and launches[k] != 0]
        if missing or stray:
            raise AssertionError(f"serve {name}: kernels not launched {missing}, stray {stray} ({launches})")
        got = outcomes(resp)
        want = list(job.prep_msgs)
        for row in bad_rows:
            want[row] = PrepareError.VDAF_PREP_ERROR
        want[unknown] = PrepareError.HPKE_UNKNOWN_CONFIG_ID
        want[expired] = PrepareError.TASK_EXPIRED
        if got != want:
            wrong = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
            raise AssertionError(f"serve {name}: {len(wrong)} reports answered otherwise than expected: {wrong[:10]}")

        def batch_rows():
            return eds.datastore.run_tx(
                lambda tx: tx._c.execute(
                    "SELECT batch_identifier, aggregate_share, report_count, checksum FROM batch_aggregations"
                ).fetchall()
            )

        rows = batch_rows()
        accept = np.array([isinstance(x, bytes) for x in got])
        field = engine.p3.circ.FIELD
        if len(rows) != 1 or rows[0][2] != int(accept.sum()):
            raise AssertionError(f"serve {name}: batch aggregation rows {[(r[0].hex(), r[2]) for r in rows]}")
        leader_share = engine.aggregate(job.out0, accept)
        total = [(a + b) % field.MODULUS for a, b in zip(leader_share, field.decode_vec(rows[0][1]))]
        if total != [int(x) for x in np.asarray(meas)[accept].sum(axis=0).reshape(-1)]:
            raise AssertionError(f"serve {name}: leader + helper shares != the accepted reports' sum")

        # the same bytes again: a byte-identical answer, no row moves
        t0 = time.perf_counter()
        again = helper.handle_aggregate_init(task.task_id, job_id, job.request)
        replay_s = time.perf_counter() - t0
        if again.to_bytes() != resp.to_bytes() or batch_rows() != rows:
            raise AssertionError(f"serve {name}: the replayed request was answered otherwise")

        # the same reports under a new job id: the whole path runs again,
        # the device step included, and every report that passed the
        # HPKE stage is now a replay
        t0 = time.perf_counter()
        warm = outcomes(helper.handle_aggregate_init(task.task_id, AggregationJobId(bytes(16)), job.request))
        warm_request_s = time.perf_counter() - t0
        warm_stages = dict(helper.task_aggregator_for(task.task_id).stage_seconds)
        want = [PrepareError.REPORT_REPLAYED] * batch
        want[unknown] = PrepareError.HPKE_UNKNOWN_CONFIG_ID
        want[expired] = PrepareError.TASK_EXPIRED
        if warm != want or batch_rows() != rows:
            raise AssertionError(f"serve {name}: the reports sent again under a new job were not all replays")

        # the seam's cost over the bare device step, in turns: the engine's
        # helper_init on the request's host columns (padding, copies,
        # combine, decide, finish, fetch) against helper_init_step on the
        # same reports already on the card
        step = api.helper_init_step(inst, VERIFY_KEY, device=dev)
        on_card = [None if args[i] is None else from_numpy_u64(args[i], dev) for i in (0, 1, 5, 6)]
        turns = {"engine_helper_init": [], "helper_init_step": []}
        for _ in range(reps):
            t0 = time.perf_counter()
            engine.helper_init(args[0], args[1], args[5], args[6], ver0, part0, np.ones(batch, dtype=bool))
            turns["engine_helper_init"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            step(*on_card)
            torch.cuda.synchronize()
            turns["helper_init_step"].append(time.perf_counter() - t0)
        return {
            "path": f"serve-{name}",
            "vdaf": inst.to_dict(),
            "batch": batch,
            "accepted": int(accept.sum()),
            "rejected": {e.name: sum(1 for g in got if g == e) for e in set(x for x in got if not isinstance(x, bytes))},
            "request_bytes": len(job.request),
            "hpke_backend": hpke_backend.BACKEND,
            "stage_s": stages,
            "request_s": request_s,
            "reports_per_s": batch / request_s,
            "replay_s": replay_s,
            "second_job_request_s": warm_request_s,
            "second_job_stage_s": warm_stages,
            "helper_init_turns_s": turns,
            "leader_init_s": routes,
            "leader_request_build_s": request_build_s,
            "shard_s": shard_s,
            "launches": launches,
            "peak_device_bytes": peak,
            "stream_plan": None if engine.p3.plan is None else [engine.p3.plan.group, engine.p3.plan.gcalls,
                                                                 engine.p3.plan.n_steps],
            "aggregate_ok": True,
            "replay_identical": True,
        }
    finally:
        eds.cleanup()


def collect_batch(torch, counters, task, leader_url: str, leader_eds, collector_kp, query, want_count: int,
                  want_result: list, batch_id: bytes | None = None, helper_http=None, dev=None):
    """Collect what a drive phase aggregated (see the module docstring,
    phases 9 and 10): a port Collector PUTs the collection to the port
    leader's DapServer, CollectionJobDriver steps it through
    JobDriver.run_once against the helper's DapServer (launch counts at 0
    just before, read just after: collection launches no kernel), and the
    collector polls and unshards; then a DELETE and a poll of the deleted
    job. helper_http: the driver's client to the helper (a taskprov task's
    sends the dap-taskprov header); dev: "cpu" for a rehearsal off the
    card. Returns the collect record."""
    import json as json_mod

    from janus_tpu_torch.aggregator.collection_job_driver import CollectionJobDriver
    from janus_tpu_torch.aggregator.core import TaskAggregator
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.collector import CollectionJobNotReady, Collector, CollectorParameters
    from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.vdaf.reference import Prio3

    params = CollectorParameters(task.task_id, leader_url, task.collector_auth_token, collector_kp)
    http = HttpClient(timeout=600)
    collector = Collector(params, task.vdaf, http)
    t0 = time.perf_counter()
    job_id = collector.start_collection(query)
    create_s = time.perf_counter() - t0
    try:
        collector.poll_once(job_id, query)
        raise AssertionError("collect: the job was ready before the driver stepped it")
    except CollectionJobNotReady as e:
        retry_after = e.retry_after_s

    driver = CollectionJobDriver(leader_eds.datastore, helper_http or HttpClient(timeout=600),
                                 breakers=OutboundCircuitBreakers())
    job_driver = JobDriver(JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(), driver.stepper)
    on_card = dev is None or torch.device(dev).type == "cuda"
    device_bytes = peak = 0
    if on_card:
        torch.cuda.synchronize()
        device_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with MethodSeconds(TaskAggregator, ["handle_aggregate_share"]) as helper_s:
        stepped = job_driver.run_once()
    step_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if on_card:
        peak = torch.cuda.max_memory_allocated()
    if stepped != 1 or not driver.step_seconds:
        raise AssertionError(f"collect: {stepped} collection jobs stepped")
    if any(launches.values()):
        raise AssertionError(f"collect: kernels launched during the collection step ({launches})")
    row = leader_eds.datastore.run_tx(lambda tx: tx._c.execute(
        "SELECT state, lease_token IS NULL, lease_attempts FROM collection_jobs WHERE collection_job_id = ?",
        (job_id.data,)).fetchall())
    if row != [("finished", 1, 0)]:
        raise AssertionError(f"collect: collection job row {row}, not finished with its lease released")
    if job_driver.run_once() != 0:
        raise AssertionError("collect: a second pass acquired a collection job")

    t0 = time.perf_counter()
    with MethodSeconds(Prio3, ["unshard"]) as unshard_s:
        result = collector.poll_once(job_id, query)
    poll_s = time.perf_counter() - t0
    if result.report_count != want_count or result.aggregate_result != want_result:
        raise AssertionError(f"collect: {result.report_count} reports, the result is not the accepted reports' sum")
    if batch_id is not None and result.partial_batch_selector.batch_id.data != batch_id:
        raise AssertionError("collect: the current batch is not the job's batch")

    # DELETE answers 204; a later poll gets janus_tpu's problem document
    uri = params.collection_job_uri(job_id)
    status, _ = http.delete(uri, task.collector_auth_token.request_headers())
    p_status, body = http.post(uri, b"", task.collector_auth_token.request_headers())
    problem = json_mod.loads(body) if p_status == 400 else {}
    if status != 204 or problem.get("type") != "urn:ietf:params:ppm:dap:error:unrecognizedCollectionJob":
        raise AssertionError(f"collect: DELETE answered {status}, the next poll {p_status} {body[:200]!r}")
    return {
        "report_count": result.report_count,
        "retry_after_s": retry_after,
        "launches": launches,
        "collect_s": {
            "create": create_s,
            "step": step_s,
            **dict(driver.step_seconds[-1][1]),
            "helper_handle_aggregate_share": helper_s["handle_aggregate_share"],
            "poll_and_unshard": poll_s,
            "unshard": unshard_s["unshard"],
        },
        "device_bytes_before": device_bytes,
        "peak_device_bytes": peak,
        "result_ok": True,
        "lease_released": True,
        "delete_ok": True,
    }


def phase_drive(torch, dev, name: str, inst, batch: int, bad_rows, kernels):
    """The leader's side end to end (see the module docstring, phase 9):
    the job creator and the lease-driven job driver step one job of
    `batch` reports over loopback HTTP against a port helper behind a
    DapServer; in fast mode the port leader, behind its own DapServer,
    then collects the batch and the garbage collector clears both
    datastores; returns the drive record."""
    import dataclasses

    import numpy as np

    from janus_tpu_torch.aggregator.aggregation_job_creator import AggregationJobCreator
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.aggregator.core import Aggregator
    from janus_tpu_torch.aggregator.garbage_collector import GarbageCollector
    from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.aggregator.testing import leader_stored_reports
    from janus_tpu_torch.convert import step_args_to_numpy
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.datastore.store import Transaction
    from janus_tpu_torch.messages import Duration, Interval, PrepareError, Query, Role, Time
    from janus_tpu_torch.task import QueryTypeConfig, Task, TaskBuilder
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    now = 1_700_000_000
    expiry_age = 7 * 24 * 3600
    counters = kernel_counters()
    collector_kp = generate_hpke_config_and_private_key(config_id=7)
    built = TaskBuilder(QueryTypeConfig.time_interval(), inst, Role.LEADER).with_(
        vdaf_verify_key=VERIFY_KEY, aggregator_auth_token=AuthenticationToken.random_bearer(),
        collector_hpke_config=collector_kp.config, report_expiry_age=Duration(expiry_age),
    ).build()
    helper_task = Task.from_dict(dataclasses.replace(
        built, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
    ).to_dict())
    leader_eds = EphemeralDatastore(MockClock(Time(now)))
    helper_eds = EphemeralDatastore(MockClock(Time(now)))
    helper = Aggregator(helper_eds.datastore, helper_eds.clock, device=dev)
    leader = Aggregator(leader_eds.datastore, leader_eds.clock, device=dev)
    server = DapServer(DapHttpApp(helper)).start()
    leader_server = DapServer(DapHttpApp(leader)).start()
    try:
        task = Task.from_dict(dataclasses.replace(built, helper_aggregator_endpoint=server.url).to_dict())
        helper_eds.datastore.run_tx(lambda tx: tx.put_task(helper_task))
        leader_eds.datastore.run_tx(lambda tx: tx.put_task(task))
        engine = leader.task_aggregator_for(task.task_id).engine

        # uploads: shard on the card, corrupt 3 leader shares, store
        meas = random_measurements(inst, batch, np.random.default_rng(SEED + 5))
        t0 = time.perf_counter()
        args, _ = make_report_batch(inst, meas, seed=SEED + 5, shard_chunk=256, device=dev)
        args = list(step_args_to_numpy(args))
        args[2] = _bump_host_rows(args[2], bad_rows, engine.p3.tf.MODULUS)
        reports = leader_stored_reports(task, helper_task.hpke_keys[0].config, args, [now - 100] * batch)
        leader_eds.datastore.run_tx(lambda tx: [tx.put_client_report(r) for r in reports])
        upload_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        created = AggregationJobCreator(leader_eds.datastore).run_once()
        create_s = time.perf_counter() - t0
        jobs = leader_eds.datastore.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(task.task_id))
        sizes = [len(leader_eds.datastore.run_tx(lambda tx: tx.get_report_aggregations_for_job(task.task_id, j.job_id)))
                 for j in jobs]
        if created != 1 or sizes != [batch]:
            raise AssertionError(f"drive {name}: the creator made {created} jobs of {sizes} reports")
        (job,) = jobs

        driver = AggregationJobDriver(leader_eds.datastore, HttpClient(timeout=600), breakers=OutboundCircuitBreakers(),
                                      device=dev)
        job_driver = JobDriver(JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(), driver.stepper)
        # the main path: counts at 0 just before, read just after
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        stepped = job_driver.run_once()
        step_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        if stepped != 1 or not driver.step_seconds:
            raise AssertionError(f"drive {name}: {stepped} jobs stepped, {len(driver.step_seconds)} step records")
        stages = dict(driver.step_seconds[-1][1])
        helper_stages = dict(helper.task_aggregator_for(helper_task.task_id).stage_seconds)

        missing = [k for k in kernels if launches[k] == 0]
        stray = [k for k in counters if k not in kernels and launches[k] != 0]
        if missing or stray:
            raise AssertionError(f"drive {name}: kernels not launched {missing}, stray {stray} ({launches})")
        row = leader_eds.datastore.run_tx(lambda tx: tx._c.execute(
            "SELECT state, lease_token IS NULL, lease_attempts FROM aggregation_jobs").fetchall())
        if row != [("finished", 1, 0)]:
            raise AssertionError(f"drive {name}: job row {row}, not finished with its lease released")
        ras = leader_eds.datastore.run_tx(lambda tx: tx.get_report_aggregations_for_job(task.task_id, job.job_id))
        ids = {r.report_id.data: i for i, r in enumerate(reports)}
        failed = sorted((ids[ra.report_id.data], ra.prepare_error) for ra in ras if ra.state.value == "failed")
        finished = sum(1 for ra in ras if ra.state.value == "finished")
        if failed != [(i, PrepareError.VDAF_PREP_ERROR) for i in sorted(bad_rows)] or finished != batch - len(bad_rows):
            raise AssertionError(f"drive {name}: {finished} finished, failed {failed[:10]}")

        field = engine.p3.circ.FIELD
        shares = []
        for eds in (leader_eds, helper_eds):
            rows = eds.datastore.run_tx(lambda tx: tx._c.execute(
                "SELECT aggregate_share, report_count FROM batch_aggregations").fetchall())
            if len(rows) != 1 or rows[0][1] != finished:
                raise AssertionError(f"drive {name}: batch aggregation rows {[r[1] for r in rows]}")
            shares.append(field.decode_vec(rows[0][0]))
        accept = np.ones(batch, dtype=bool)
        accept[list(bad_rows)] = False
        total = [(a + b) % field.MODULUS for a, b in zip(*shares)]
        if total != [int(x) for x in np.asarray(meas)[accept].sum(axis=0).reshape(-1)]:
            raise AssertionError(f"drive {name}: leader + helper shares != the accepted reports' sum")
        if job_driver.run_once() != 0:
            raise AssertionError(f"drive {name}: a second pass acquired a job")

        # the two leader routes in turns on the job's own staged columns
        reports_by_id = {r.report_id.data: r for r in reports}
        st = driver.stage_init(None, task, job, ras, reports_by_id)
        cols = (st.nonce_lanes, st.public_parts, st.meas, st.proof, st.blind_lanes)
        routes = {"pipelined": [], "direct": []}
        vers = {}
        for route in ("pipelined", "direct"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == "pipelined":
                out0, _, ver0, _ = engine.leader_init(*cols, ok=st.ok)
            else:
                out0, _, ver0, _ = engine._leader_init_inner(*cols, allow_pipeline=False)
            torch.cuda.synchronize()
            routes[route].append(time.perf_counter() - t0)
            want_type = "DeviceRowsChunks" if route == "pipelined" else "DeviceRows"
            if type(out0).__name__ != want_type:
                raise AssertionError(f"drive {name}: leader_init took another route than {route}")
            vers[route] = ver0
            del out0
        if any(not np.array_equal(a, b) for a, b in zip(vers["pipelined"], vers["direct"])):
            raise AssertionError(f"drive {name}: the two leader routes disagree")

        collect = None
        if inst.xof_mode == "fast":
            window = Time(now - 100).to_batch_interval_start(task.time_precision)
            collect = collect_batch(
                torch, counters, task, leader_server.url, leader_eds, collector_kp,
                Query.time_interval(Interval(window, task.time_precision)), finished,
                [int(x) for x in np.asarray(meas)[accept].sum(axis=0).reshape(-1)],
            )
            # past report_expiry_age, GC clears the reports, the jobs and
            # the collection artifacts of both datastores
            # the seconds of each side's pass and, summed over both, of each
            # delete it calls (the rest of a pass is BEGIN and COMMIT)
            gc, gc_s = {}, {}
            deletes = ["delete_expired_client_reports", "delete_expired_aggregation_artifacts",
                       "delete_expired_collection_artifacts"]
            with MethodSeconds(Transaction, deletes) as delete_s:
                for side, eds in (("leader", leader_eds), ("helper", helper_eds)):
                    eds.clock.advance(Duration(expiry_age + 2 * task.time_precision.seconds))
                    t0 = time.perf_counter()
                    gc[side] = GarbageCollector(eds.datastore, eds.clock).run_once()
                    gc_s[side] = time.perf_counter() - t0
            collect["collect_s"]["gc"] = sum(gc_s.values())
            collect["gc_s"] = {**gc_s, **delete_s}
            want_gc = {"leader": {"reports": batch, "aggregation": 1, "collection": 1},
                       "helper": {"reports": 0, "aggregation": 1, "collection": 0}}
            left = [eds.datastore.run_tx(lambda tx: [tx._c.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0] for t in (
                "client_reports", "aggregation_jobs", "report_aggregations", "collection_jobs")])
                for eds in (leader_eds, helper_eds)]
            if gc != want_gc or left != [[0, 0, 0, 0]] * 2:
                raise AssertionError(f"drive {name}: GC deleted {gc}, rows left {left}")
            collect["gc"] = gc
        return {
            "path": f"drive-{name}",
            "vdaf": inst.to_dict(),
            "batch": batch,
            "jobs_created": created,
            "finished": finished,
            "failed": {"VDAF_PREP_ERROR": len(failed)},
            "upload_s": upload_s,
            "create_s": create_s,
            "step_s": step_s,
            "reports_per_s": batch / step_s,
            "stage_s": stages,
            "helper_stage_s": helper_stages,
            "leader_init_turns_s": routes,
            "launches": launches,
            "peak_device_bytes": peak,
            "aggregate_ok": True,
            "lease_released": True,
            "collect": collect,
        }
    finally:
        leader_server.stop()
        server.stop()
        leader.close()
        leader_eds.cleanup()
        helper_eds.cleanup()


def phase_upload_drive(torch, dev, inst, n_client: int, n_wire: int, bad_rows, kernels, threads: int = 8):
    """The leader's intake end to end (see the module docstring, phase
    10): reports uploaded over loopback HTTP to a port leader, admitted,
    decoded, opened, validated and group-committed by its ingest
    pipeline, packed into one fixed-size batch by the creator, and
    stepped by the job driver against a port helper, then collected by a
    current-batch query; returns the record."""
    import dataclasses
    import json as json_mod
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from janus_tpu_torch.aggregator.aggregation_job_creator import AggregationJobCreator
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.aggregator.core import Aggregator
    from janus_tpu_torch.aggregator.engine_cache import EngineCache
    from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.client import Client, ClientParameters
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers
    from janus_tpu_torch.core.hpke import (
        HpkeApplicationInfo,
        Label,
        generate_hpke_config_and_private_key,
        hpke_open,
        hpke_seal,
    )
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.retries import Backoff, retry_http_request
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.datastore.store import Crypter, Transaction
    from janus_tpu_torch.messages import (
        FixedSizeQuery,
        InputShareAad,
        PartialBatchSelector,
        PlaintextInputShare,
        PrepareError,
        Query,
        Report,
        ReportId,
        ReportMetadata,
        Role,
        Time,
    )
    from janus_tpu_torch.task import QueryTypeConfig, Task, TaskBuilder
    from janus_tpu_torch.fields.field import Field128
    from janus_tpu_torch.vdaf.registry import circuit_for
    from janus_tpu_torch.vdaf.testing import make_wire_reports, random_measurements
    from janus_tpu_torch.vdaf.wire import flat_scatter_indices

    now = 1_700_000_000
    batch = n_client + n_wire
    sparse = inst.kind == "sparse_sumvec"
    counters = kernel_counters()

    def check_launches(what, launches, want=kernels):
        _check_launches(torch, dev, f"upload-drive {what}", launches, tuple(want))

    leader_eds = EphemeralDatastore(MockClock(Time(now)))
    helper_eds = EphemeralDatastore(MockClock(Time(now)))
    helper = Aggregator(helper_eds.datastore, helper_eds.clock, device=dev)
    leader = Aggregator(leader_eds.datastore, leader_eds.clock, device=dev)
    helper_server = DapServer(DapHttpApp(helper)).start()
    leader_server = DapServer(DapHttpApp(leader)).start()
    try:
        collector_kp = generate_hpke_config_and_private_key(config_id=7)
        built = TaskBuilder(QueryTypeConfig.fixed_size(max_batch_size=batch), inst, Role.LEADER).with_(
            vdaf_verify_key=VERIFY_KEY, aggregator_auth_token=AuthenticationToken.random_bearer(),
            leader_aggregator_endpoint=leader_server.url, helper_aggregator_endpoint=helper_server.url,
            collector_hpke_config=collector_kp.config,
        ).build()
        task = Task.from_dict(built.to_dict())
        helper_task = Task.from_dict(dataclasses.replace(
            built, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
        ).to_dict())
        leader_eds.datastore.run_tx(lambda tx: tx.put_task(task))
        helper_eds.datastore.run_tx(lambda tx: tx.put_task(helper_task))
        http = HttpClient(timeout=600)
        params = ClientParameters(task.task_id, leader_server.url, helper_server.url, task.time_precision)
        if sparse:
            meas, block_idx, compact = sparse_measurements(inst, batch, SEED + 7)
        else:
            meas = random_measurements(inst, batch, np.random.default_rng(SEED + 7))

        # 1. the client: both HPKE configs over HTTP, then one host shard
        # and one upload a report
        client = Client.with_fetched_configs(params, inst, http, clock=leader_eds.clock)
        client_upload_s = []
        for m in meas[:n_client]:
            t0 = time.perf_counter()
            client.upload(m if sparse else [int(x) for x in m])
            client_upload_s.append(time.perf_counter() - t0)

        # 2. the batched client: the device shard (counts at 0 just
        # before, read just after) and the seals; then 3 reports opened,
        # their leader measurement share bumped, and sealed again
        _sync(torch, dev)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        reports = make_wire_reports(
            inst, meas[n_client:], task.task_id, client.leader_hpke_config, client.helper_hpke_config,
            Time(now - 100).to_batch_interval_start(task.time_precision), seed=SEED + 7, shard_chunk=256,
            device=dev,
        )
        wire_reports_s = time.perf_counter() - t0
        shard_launches = {k: fn.launches for k, fn in counters.items()}
        check_launches("device shard", shard_launches)
        keypair = task.hpke_keys[0]
        info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER)
        field = circuit_for(inst).FIELD
        size = field.ENCODED_SIZE

        def reseal(src, md, mutate):
            """`src` as `md`, its leader payload changed by mutate(bytearray)
            and sealed again: the client's seal of another share."""
            payload = bytearray(PlaintextInputShare.from_bytes(hpke_open(
                keypair, info, src.leader_encrypted_input_share,
                InputShareAad(task.task_id, src.metadata, src.public_share).to_bytes(),
            )).payload)
            mutate(payload)
            return Report(md, src.public_share, hpke_seal(
                client.leader_hpke_config, info, PlaintextInputShare((), bytes(payload)).to_bytes(),
                InputShareAad(task.task_id, md, src.public_share).to_bytes(),
            ), src.helper_encrypted_input_share)

        def bump(payload):  # the first measurement element plus 1, inside the field
            v = (int.from_bytes(payload[:size], "little") + 1) % field.MODULUS
            payload[:size] = v.to_bytes(size, "little")

        for i in bad_rows:
            reports[i] = reseal(reports[i], reports[i].metadata, bump)

        # 3. the threaded PUTs, each through the retry loop; 429 sheds
        # are counted as the loop retries through them
        sheds = []

        def put(report):
            def attempt():
                status, body = http.put(params.upload_uri(), report.to_bytes(), {"Content-Type": Report.MEDIA_TYPE})
                if status == 429:
                    sheds.append(1)
                return status, body, http.last_response_headers

            return retry_http_request(attempt, Backoff())[0]

        # the writer's commit split: the at-rest encrypt of each share, and
        # put_client_report as a whole (the encrypt and the INSERT)
        t0 = time.perf_counter()
        with MethodSeconds(Crypter, ["encrypt"]) as enc_s, MethodSeconds(Transaction, ["put_client_report"]) as put_s:
            with ThreadPoolExecutor(max_workers=threads) as pool:
                statuses = list(pool.map(put, reports))
        upload_s = time.perf_counter() - t0
        if set(statuses) != {201}:
            raise AssertionError(f"upload-drive: upload statuses {sorted(set(statuses))}")

        def count_rows():
            return leader_eds.datastore.run_tx(lambda tx: tx._c.execute("SELECT COUNT(*) FROM client_reports").fetchone()[0])

        if count_rows() != batch:
            raise AssertionError(f"upload-drive: {count_rows()} stored reports, not {batch}")
        # a replay: 201, and no row added
        if put(reports[0]) != 201 or count_rows() != batch:
            raise AssertionError("upload-drive: the replayed upload was answered otherwise or added a row")
        # a leader share with an element >= p: janus_tpu's 400 reportRejected
        bad = reseal(reports[1], ReportMetadata(ReportId(bytes(16)), reports[1].metadata.time),
                     lambda p: p.__setitem__(slice(0, size), field.MODULUS.to_bytes(size, "little")))
        status, body = http.put(params.upload_uri(), bad.to_bytes(), {"Content-Type": Report.MEDIA_TYPE})
        problem = json_mod.loads(body)
        if status != 400 or problem.get("type") != "urn:ietf:params:ppm:dap:error:reportRejected":
            raise AssertionError(f"upload-drive: the out-of-range share was answered {status} {body[:200]!r}")
        if count_rows() != batch:
            raise AssertionError("upload-drive: the rejected upload added a row")
        if sparse:
            # descending block indices in the public share: janus_tpu's 400
            # invalidMessage, from the index predicate, before any decrypt
            k = next(i for i in range(n_wire) if block_idx[n_client + i, 1] >= 0)
            blob = bytearray(reports[k].public_share)
            blob[0:4], blob[4:8] = blob[4:8], blob[0:4]
            bad = Report(ReportMetadata(ReportId(bytes([1]) * 16), reports[k].metadata.time), bytes(blob),
                         reports[k].leader_encrypted_input_share, reports[k].helper_encrypted_input_share)
            status, body = http.put(params.upload_uri(), bad.to_bytes(), {"Content-Type": Report.MEDIA_TYPE})
            problem = json_mod.loads(body)
            if status != 400 or problem.get("type") != "urn:ietf:params:ppm:dap:error:invalidMessage":
                raise AssertionError(f"upload-drive: the bad block indices were answered {status} {body[:200]!r}")
            if count_rows() != batch:
                raise AssertionError("upload-drive: the upload with bad block indices added a row")
        ingest_stages = dict(leader_server.app._ingest.stage_seconds)
        writer_stages = dict(leader.report_writer.stage_seconds)

        # 4. fixed-size job creation: one filled batch, one job; the
        # seconds of each transaction method it calls
        tx_methods = [n for n in vars(Transaction) if not n.startswith("_") and callable(getattr(Transaction, n))]
        t0 = time.perf_counter()
        with MethodSeconds(Transaction, tx_methods) as create_tx_s:
            created = AggregationJobCreator(leader_eds.datastore).run_once()
        create_s = time.perf_counter() - t0
        jobs = leader_eds.datastore.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(task.task_id))
        sizes = [len(leader_eds.datastore.run_tx(lambda tx: tx.get_report_aggregations_for_job(task.task_id, j.job_id)))
                 for j in jobs]
        if created != 1 or sizes != [batch]:
            raise AssertionError(f"upload-drive: the creator made {created} jobs of {sizes} reports")
        (job,) = jobs
        batch_id = PartialBatchSelector.from_bytes(job.partial_batch_identifier).batch_id.data
        outstanding = leader_eds.datastore.run_tx(lambda tx: tx._c.execute(
            "SELECT batch_id, size, filled FROM outstanding_batches").fetchall())
        if outstanding != [(batch_id, batch, 1)]:
            raise AssertionError(f"upload-drive: outstanding batches {[(r[1], r[2]) for r in outstanding]}")

        # 5. the job step (counts at 0 just before, read just after)
        driver = AggregationJobDriver(leader_eds.datastore, HttpClient(timeout=600),
                                      breakers=OutboundCircuitBreakers(), device=dev)
        job_driver = JobDriver(JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(), driver.stepper)
        _peak_reset(torch, dev)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with MethodSeconds(EngineCache, ["aggregate_sparse"]) as agg_sparse_s, \
                MethodSeconds(Field128, ["encode_vec"]) as encode_s:
            stepped = job_driver.run_once()
        step_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = _peak(torch, dev)
        if stepped != 1 or not driver.step_seconds:
            raise AssertionError(f"upload-drive: {stepped} jobs stepped")
        # a sparse job's accumulate scatters on kernel 4
        check_launches("job step", launches, tuple(kernels) + (("scatter_rows",) if sparse else ()))
        row = leader_eds.datastore.run_tx(lambda tx: tx._c.execute(
            "SELECT state, lease_token IS NULL, lease_attempts FROM aggregation_jobs").fetchall())
        if row != [("finished", 1, 0)]:
            raise AssertionError(f"upload-drive: job row {row}, not finished with its lease released")
        ras = leader_eds.datastore.run_tx(lambda tx: tx.get_report_aggregations_for_job(task.task_id, job.job_id))
        ids = {r.metadata.report_id.data: n_client + i for i, r in enumerate(reports)}
        failed = sorted((ids.get(ra.report_id.data, -1), ra.prepare_error) for ra in ras if ra.state.value == "failed")
        finished = sum(1 for ra in ras if ra.state.value == "finished")
        want_failed = [(n_client + i, PrepareError.VDAF_PREP_ERROR) for i in sorted(bad_rows)]
        if failed != want_failed or finished != batch - len(bad_rows):
            raise AssertionError(f"upload-drive: {finished} finished, failed {failed[:10]}")

        accept = np.ones(batch, dtype=bool)
        accept[[n_client + i for i in bad_rows]] = False
        shares = []
        for eds in (leader_eds, helper_eds):
            rows = eds.datastore.run_tx(lambda tx: tx._c.execute(
                "SELECT batch_identifier, aggregate_share, report_count FROM batch_aggregations").fetchall())
            if len(rows) != 1 or rows[0][0] != batch_id or rows[0][2] != finished:
                raise AssertionError(f"upload-drive: batch aggregation rows {[(r[0].hex(), r[2]) for r in rows]}")
            shares.append(field.decode_vec(rows[0][1]))
        total = [(a + b) % field.MODULUS for a, b in zip(*shares)]
        if sparse:
            L = circuit_for(inst).agg_output_len
            flat = flat_scatter_indices(block_idx, circuit_for(inst))
            truth = sparse_truth(L, flat, compact, np.flatnonzero(accept))
        else:
            truth = [int(x) for x in np.asarray(meas)[accept].sum(axis=0).reshape(-1)]
        if total != truth:
            raise AssertionError("upload-drive: leader + helper shares != the accepted reports' sum")

        # 6. collection of the filled batch by a current-batch query
        with MethodSeconds(Field128, ["decode_vec"]) as decode_s:
            collect = collect_batch(
                torch, counters, task, leader_server.url, leader_eds, collector_kp,
                Query.fixed_size(FixedSizeQuery(FixedSizeQuery.CURRENT_BATCH)), finished, truth, batch_id=batch_id,
                dev=dev,
            )
        return {
            "path": "upload-drive-sparse" if sparse else "upload-drive-sumvec",
            "vdaf": inst.to_dict(),
            "query_type": {"fixed_size": {"max_batch_size": batch}},
            "batch": batch,
            "client_uploads": n_client,
            "client_upload_s": client_upload_s,
            "wire_reports": n_wire,
            "wire_reports_s": wire_reports_s,
            "upload_threads": threads,
            "upload_s": upload_s,
            "uploads_per_s": n_wire / upload_s,
            "upload_bytes": sum(len(r.to_bytes()) for r in reports),
            "sheds_429": len(sheds),
            "ingest_stage_s": {**ingest_stages, **writer_stages},
            "commit_split_s": {"at_rest_encrypt": enc_s["encrypt"], "put_client_report": put_s["put_client_report"]},
            "jobs_created": created,
            "create_s": create_s,
            "create_tx_s": {k: v for k, v in create_tx_s.items() if v > 0},
            "step_s": step_s,
            "reports_per_s": batch / step_s,
            "stage_s": dict(driver.step_seconds[-1][1]),
            "helper_stage_s": dict(helper.task_aggregator_for(helper_task.task_id).stage_seconds),
            "finished": finished,
            "failed": {"VDAF_PREP_ERROR": len(failed)},
            "shard_launches": shard_launches,
            "launches": launches,
            "peak_device_bytes": peak,
            "aggregate_ok": True,
            "lease_released": True,
            "replay_ok": True,
            "out_of_range_rejected": True,
            "bad_indices_rejected": sparse,
            # host work at the aggregate's length (the logical length when
            # sparse): the job step's aggregate_sparse (both parties: the
            # scatters, the fetch, the int conversion) and encode_vec, and
            # the collection's decode_vec (the collector's two shares)
            "host_aggregate_len_s": {
                "aggregate_sparse": agg_sparse_s["aggregate_sparse"],
                "encode_vec": encode_s["encode_vec"],
                "collect_decode_vec": decode_s["decode_vec"],
            },
            "collect": collect,
        }
    finally:
        leader_server.stop()
        helper_server.stop()
        leader.close()
        leader_eds.cleanup()
        helper_eds.cleanup()


def corrupt_poplar1_keys(poplar):
    """tests/test_poplar1_dap.py's corrupt report: the leader's key of one
    sharding (of 0b1100...) with the helper's key of another (of
    0b0011...), both read against the first's public share; returns
    (public share correction words, leader key, helper key)."""
    from janus_tpu_torch.vdaf.poplar1 import IdpfKey

    cws_a, (k0_a, _) = poplar.shard(0b1100 << (poplar.bits - 4))
    _, (_, k1_b) = poplar.shard(0b0011 << (poplar.bits - 4))
    return cws_a, k0_a, IdpfKey(k1_b.root_seed, cws_a, corr=k1_b.corr)


def phase_poplar1(torch, dev):
    """Poplar1's full-width prepare (see the module docstring, phase 11):
    both parties' batched IDPF walk and sketch at the leaf level of
    Poplar1(16), 256 prefixes, 512 reports, 3 of them with a mismatched
    helper key; returns the record."""
    import numpy as np

    from janus_tpu_torch.vdaf.poplar1 import Poplar1, Poplar1AggParam
    from janus_tpu_torch.vdaf.poplar1_device import prepare_init_batched

    bits, level, batch = POPLAR1_BITS, POPLAR1_BITS - 1, POPLAR1_BATCH
    bad = (11, 200, 497)
    counters = kernel_counters()
    rng = np.random.default_rng(POPLAR1_SEED)
    poplar = Poplar1(bits)
    t0 = time.perf_counter()
    alphas = [int(rng.integers(0, 1 << bits)) for _ in range(batch)]
    keys0, keys1 = [], []
    for a in alphas:
        _, (k0, k1) = poplar.shard(a)
        keys0.append(k0)
        keys1.append(k1)
    for i in bad:
        _, keys0[i], keys1[i] = corrupt_poplar1_keys(poplar)
    prefixes = tuple(sorted(rng.choice(1 << bits, size=POPLAR1_PREFIXES, replace=False).tolist()))
    nonces = [rng.bytes(16) for _ in alphas]
    param = Poplar1AggParam(level, prefixes)
    shard_s = time.perf_counter() - t0
    F = poplar.idpf.field_at(level)

    def both_parties(seconds):
        outs = []
        for party, keys in ((0, keys0), (1, keys1)):
            split = {}
            outs.append(prepare_init_batched(bits, party, keys, param, VERIFY_KEY, nonces, dev, seconds=split))
            seconds.append(split)
        return outs

    def sketch_ok(outs):
        (y0, A0, B0, a0, c0), (y1, A1, B1, a1, c1) = outs
        ok = []
        for i in range(batch):
            A, B = F.add(A0[i], A1[i]), F.add(B0[i], B1[i])
            s0 = F.add(F.neg(F.sub(F.mul(2, F.mul(A, a0[i])), c0[i])), F.sub(F.mul(A, A), B))
            s1 = F.neg(F.sub(F.mul(2, F.mul(A, a1[i])), c1[i]))
            ok.append(F.add(s0, s1) == 0)
        return ok

    both_parties([])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    split = []
    t0 = time.perf_counter()
    outs = both_parties(split)
    step_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want_launches = {"keccak_single_block": 2 * (2 * (level + 1) + 1), "expand_f128": 0, "keccak_sponge": 0,
                     "scatter_rows": 0}
    if launches != want_launches:
        raise AssertionError(f"poplar1: launches {launches}, not {want_launches}")
    ok = sketch_ok(outs)
    if [i for i in range(batch) if not ok[i]] != list(bad):
        raise AssertionError(f"poplar1: the sketch failed for {[i for i in range(batch) if not ok[i]][:10]}")
    # 8 reports, a corrupted one among them, against the host walk
    t0 = time.perf_counter()
    for i in (0, 1, bad[0], 100, 255, 256, 400, batch - 1):
        for party, keys in ((0, keys0), (1, keys1)):
            state, msg1 = poplar.prepare_init(party, keys[i], param, VERIFY_KEY, nonces[i])
            y, A, B, a, c = outs[party]
            if (y[i], A[i], B[i], a[i], c[i]) != (state.y_shares, msg1[0], msg1[1], state.a_share, state.c_share):
                raise AssertionError(f"poplar1: report {i}, party {party} disagrees with the host walk")
    host_check_s = time.perf_counter() - t0
    host_s = [{k: v for k, v in sp.items() if k != "device"} for sp in split]
    return {
        "path": "poplar1",
        "vdaf": {"kind": "poplar1", "bits": bits},
        "level": level,
        "prefixes": len(prefixes),
        "batch": batch,
        "shard_s": shard_s,
        "two_party_step_s": step_s,
        "reports_per_s": batch / step_s,
        "host_s_by_party": host_s,
        "host_s": sum(sum(h.values()) for h in host_s),
        "device_s": sum(sp["device"] for sp in split),
        "verified": sum(ok),
        "host_walk_check_s": host_check_s,
        "launches": launches,
        "peak_device_bytes": peak,
    }


class LaunchesIn:
    """While open, adds the kernel launches made inside the named methods
    of `cls` to `launches[name]` (one thread at a time)."""

    def __init__(self, cls, names, counters):
        self.cls, self.names, self.counters = cls, names, counters
        self.launches = {n: {k: 0 for k in counters} for n in names}

    def __enter__(self):
        self._saved = {n: getattr(self.cls, n) for n in self.names}
        for n, fn in self._saved.items():
            setattr(self.cls, n, self._counted(n, fn))
        return self.launches

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self.cls, n, fn)

    def _counted(self, name, fn):
        def counted(*a, **kw):
            before = {k: c.launches for k, c in self.counters.items()}
            try:
                return fn(*a, **kw)
            finally:
                for k, c in self.counters.items():
                    self.launches[name][k] += c.launches - before[k]

        return counted


def phase_drive_poplar1(torch, dev, n_reports: int = 1024, threshold: int = 32, threads: int = 8):
    """Heavy hitters through DAP (see the module docstring, phase 12): a
    port leader and a port helper behind their DapServers, 1,024 uploads
    through the port's Client (3 corrupted), and a port Collector walking
    the 16 levels of Poplar1(16), each level's collection driven by
    JobDriver.run_once of the collection and aggregation drivers; returns
    the record."""
    import dataclasses
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.aggregator.collection_job_driver import CollectionJobDriver
    from janus_tpu_torch.aggregator.core import Aggregator, TaskAggregator
    from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.client import Client, ClientParameters
    from janus_tpu_torch.collector import Collector, CollectorParameters
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers
    from janus_tpu_torch.core.hpke import HpkeApplicationInfo, Label, generate_hpke_config_and_private_key, hpke_seal
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.retries import Backoff, retry_http_request
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.messages import (
        Duration,
        InputShareAad,
        Interval,
        PlaintextInputShare,
        Query,
        Report,
        Role,
        Time,
    )
    from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder
    from janus_tpu_torch.vdaf.poplar1 import Poplar1AggParam, encode_input_share, encode_public_share
    from janus_tpu_torch.vdaf.registry import VdafInstance

    bits = POPLAR1_BITS
    now = 1_700_000_000
    counters = kernel_counters()
    rng = np.random.default_rng(POPLAR1_SEED + 1)
    heavy_values = sorted(int(x) for x in rng.choice(1 << bits, size=8, replace=False))
    meas = []
    for v in heavy_values:
        meas += [v] * int(rng.integers(48, 97))
    meas += [int(x) for x in rng.integers(0, 1 << bits, size=n_reports - len(meas))]
    meas = [meas[i] for i in rng.permutation(n_reports)]
    bad = {5, 500, 1000}
    honest = np.array([m for i, m in enumerate(meas) if i not in bad])
    values, counts = np.unique(honest, return_counts=True)
    want_heavy = sorted(int(v) for v, c in zip(values, counts) if c >= threshold)

    # the interpreter's garbage-collection pauses, by level (any thread)
    gc_pause = {"s": 0.0, "gen2": 0, "t0": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            gc_pause["t0"] = time.perf_counter()
        else:
            gc_pause["s"] += time.perf_counter() - gc_pause["t0"]
            gc_pause["gen2"] += info["generation"] == 2

    collector_kp = generate_hpke_config_and_private_key(config_id=7)
    leader_eds = EphemeralDatastore(MockClock(Time(now)))
    helper_eds = EphemeralDatastore(MockClock(Time(now)))
    helper = Aggregator(helper_eds.datastore, helper_eds.clock, device=dev)
    leader = Aggregator(leader_eds.datastore, leader_eds.clock, device=dev)
    helper_server = DapServer(DapHttpApp(helper)).start()
    leader_server = DapServer(DapHttpApp(leader)).start()
    try:
        inst = VdafInstance.poplar1(bits)
        task = TaskBuilder(QueryTypeConfig.time_interval(), inst, Role.LEADER).with_(
            vdaf_verify_key=VERIFY_KEY, aggregator_auth_token=AuthenticationToken.random_bearer(),
            collector_hpke_config=collector_kp.config, min_batch_size=1, max_batch_query_count=bits + 1,
            leader_aggregator_endpoint=leader_server.url, helper_aggregator_endpoint=helper_server.url,
        ).build()
        helper_task = dataclasses.replace(
            task, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
        )
        leader_eds.datastore.run_tx(lambda tx: tx.put_task(task))
        helper_eds.datastore.run_tx(lambda tx: tx.put_task(helper_task))
        http = HttpClient(timeout=600)
        params = ClientParameters(task.task_id, leader_server.url, helper_server.url, task.time_precision)
        client = Client.with_fetched_configs(params, inst, http, clock=leader_eds.clock)

        def prepare(i):
            report = client.prepare_report(meas[i])
            if i not in bad:
                return report
            cws, k0, k1 = corrupt_poplar1_keys(client.poplar)
            public = encode_public_share(bits, cws)
            aad = InputShareAad(task.task_id, report.metadata, public).to_bytes()
            seal = [hpke_seal(cfg, HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, role),
                              PlaintextInputShare((), encode_input_share(key, party, bits)).to_bytes(), aad)
                    for cfg, role, key, party in ((client.leader_hpke_config, Role.LEADER, k0, 0),
                                                  (client.helper_hpke_config, Role.HELPER, k1, 1))]
            return dataclasses.replace(report, public_share=public, leader_encrypted_input_share=seal[0],
                                       helper_encrypted_input_share=seal[1])

        def upload(i):
            report = prepare(i)

            def attempt():
                status, body = http.put(params.upload_uri(), report.to_bytes(), {"Content-Type": Report.MEDIA_TYPE})
                return status, body, http.last_response_headers

            return retry_http_request(attempt, Backoff())[0]

        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=threads) as pool:
            statuses = list(pool.map(upload, range(n_reports)))
        upload_s = time.perf_counter() - t0
        if set(statuses) != {201} or any(fn.launches for fn in counters.values()):
            raise AssertionError(f"drive-poplar1: upload statuses {sorted(set(statuses))}")

        cfg = JobDriverConfig(max_concurrent_job_workers=1)
        adriver = AggregationJobDriver(leader_eds.datastore, HttpClient(timeout=600),
                                       breakers=OutboundCircuitBreakers(), device=dev)
        cdriver = CollectionJobDriver(leader_eds.datastore, HttpClient(timeout=600),
                                      breakers=OutboundCircuitBreakers())
        ajobs = JobDriver(cfg, adriver.acquirer(), adriver.stepper)
        cjobs = JobDriver(cfg, cdriver.acquirer(), cdriver.stepper)
        collector = Collector(CollectorParameters(task.task_id, leader_server.url, task.collector_auth_token,
                                                  collector_kp), inst, HttpClient(timeout=600))
        query = Query.time_interval(Interval(Time(now).to_batch_interval_start(task.time_precision),
                                             Duration(task.time_precision.seconds)))

        def counted(fn):
            before = {k: c.launches for k, c in counters.items()}
            t0 = time.perf_counter()
            out = fn()
            return out, time.perf_counter() - t0, {k: c.launches - before[k] for k, c in counters.items()}

        def add(into: dict, secs: dict) -> None:
            for k, v in secs.items():
                into[k] = into.get(k, 0.0) + v

        helper_ta = helper.task_aggregator_for(helper_task.task_id)
        gc.callbacks.append(on_gc)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        levels = []
        candidates = [0, 1]
        t_walk = time.perf_counter()
        for level in range(bits):
            rec = {"level": level, "prefixes": len(candidates), "init_s": 0.0, "continue_s": 0.0,
                   "collection_s": 0.0, "init_steps": 0, "continue_steps": 0, "collection_steps": 0,
                   "launches": {k: 0 for k in counters}, "init_stage_s": {}, "helper_init_stage_s": {}}
            gc_pause.update(s=0.0, gen2=0)
            agg_param = Poplar1AggParam(level, tuple(candidates)).encode()
            t0 = time.perf_counter()
            job_id = collector.start_collection(query, agg_param=agg_param)
            rec["create_s"] = time.perf_counter() - t0
            per_side = 2 * (level + 1) + 1
            with MethodSeconds(TaskAggregator, ["handle_aggregate_init", "handle_aggregate_continue"]) as helper_s, \
                    LaunchesIn(TaskAggregator, ["handle_aggregate_init"], counters) as helper_launches:
                for _ in range(16):
                    stepped, secs, launched = counted(cjobs.run_once)
                    if stepped:
                        rec["collection_steps"] += 1
                        rec["collection_s"] += secs
                        if any(launched.values()):
                            raise AssertionError(f"drive-poplar1 level {level}: a collection step launched {launched}")
                    ran_agg = 0
                    while True:
                        n_before = len(adriver.step_seconds)
                        stepped_a, secs, launched = counted(ajobs.run_once)
                        if not stepped_a:
                            break
                        ran_agg += 1
                        for k, v in launched.items():
                            rec["launches"][k] += v
                        stage = adriver.step_seconds[-1][1] if len(adriver.step_seconds) > n_before else {}
                        if "http_continue" in stage:
                            rec["continue_steps"] += 1
                            rec["continue_s"] += secs
                            if any(launched.values()):
                                raise AssertionError(f"drive-poplar1 level {level}: a continue step launched {launched}")
                        else:
                            rec["init_steps"] += 1
                            rec["init_s"] += secs
                            add(rec["init_stage_s"], stage)
                            add(rec["helper_init_stage_s"], helper_ta.stage_seconds)
                            want = {"keccak_single_block": 2 * per_side, "expand_f128": 0, "keccak_sponge": 0,
                                    "scatter_rows": 0}
                            if launched != want:
                                raise AssertionError(f"drive-poplar1 level {level}: an init step launched {launched}")
                    if not stepped and not ran_agg:
                        break
            helper_init = helper_launches["handle_aggregate_init"]
            if helper_init["keccak_single_block"] != per_side * rec["init_steps"]:
                raise AssertionError(f"drive-poplar1 level {level}: the helper's inits launched {helper_init}")
            rec["helper_init_s"] = helper_s["handle_aggregate_init"]
            rec["helper_continue_s"] = helper_s["handle_aggregate_continue"]
            rec["gc_pause_s"], rec["gc_gen2"] = gc_pause["s"], gc_pause["gen2"]
            t0 = time.perf_counter()
            result = collector.poll_once(job_id, query, agg_param=agg_param)
            rec["poll_s"] = time.perf_counter() - t0
            truth = [int(np.sum((honest >> (bits - 1 - level)) == p)) for p in candidates]
            if result.report_count != n_reports - len(bad) or result.aggregate_result != truth:
                raise AssertionError(f"drive-poplar1 level {level}: {result.report_count} reports, counts off")
            jobs_per = -(-n_reports // 512)
            if (rec["init_steps"], rec["continue_steps"]) != (jobs_per, jobs_per):
                raise AssertionError(f"drive-poplar1 level {level}: steps {rec}")
            survivors = [p for p, c in zip(candidates, result.aggregate_result) if c >= threshold]
            want_survivors = [p for p, c in zip(candidates, truth) if c >= threshold]
            if survivors != want_survivors:
                raise AssertionError(f"drive-poplar1 level {level}: survivors differ from the ground truth's")
            rec["survivors"] = len(survivors)
            levels.append(rec)
            candidates = sorted([p << 1 for p in survivors] + [(p << 1) | 1 for p in survivors])
        walk_s = time.perf_counter() - t_walk
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        if survivors != want_heavy:
            raise AssertionError(f"drive-poplar1: heavy set {survivors}, not {want_heavy}")
        if launches["expand_f128"] or launches["keccak_sponge"]:
            raise AssertionError(f"drive-poplar1: stray launches {launches}")
        return {
            "path": "drive-poplar1",
            "vdaf": inst.to_dict(),
            "reports": n_reports,
            "corrupted": len(bad),
            "threshold": threshold,
            "heavy": len(want_heavy),
            "heavy_ok": True,
            "upload_threads": threads,
            "upload_s": upload_s,
            "walk_s": walk_s,
            "total_s": upload_s + walk_s,
            "levels": levels,
            "launches": launches,
            "peak_device_bytes": peak,
        }
    finally:
        if on_gc in gc.callbacks:
            gc.callbacks.remove(on_gc)
        leader_server.stop()
        helper_server.stop()
        leader.close()
        helper.close()
        leader_eds.cleanup()
        helper_eds.cleanup()


def _on_card(torch, dev) -> bool:
    return torch.device(dev).type == "cuda"


def _sync(torch, dev) -> None:
    """Wait for the card (a rehearsal on the CPU has nothing to wait for)."""
    if _on_card(torch, dev):
        torch.cuda.synchronize()


def _peak_reset(torch, dev) -> int:
    """Synchronize and start a peak window; the bytes allocated now (0 off the card)."""
    if not _on_card(torch, dev):
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak(torch, dev) -> int:
    """The window's peak device bytes (0 off the card)."""
    return torch.cuda.max_memory_allocated() if _on_card(torch, dev) else 0


def _percentile(xs, q: float):
    """The q-quantile (nearest rank) of xs, or None for none."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))]


class TaskprovPair:
    """The taskprov deployment of phases 13 and 14: a port leader on the
    Postgres engine (PostgresDatastore over the port's pg_fake driver)
    with the upload journal armed, and a port helper on SQLite with
    taskprov enabled, each an Aggregator behind its own DapServer. The
    helper holds one active global HPKE keypair and the leader as its
    taskprov PeerAggregator; the task is a TaskConfig of Prio3Histogram
    (boundaries 1 .. length - 1), fast mode, time interval, and the leader
    provisions its side out of band with the peer's derived verify key.
    Neither supervisor runs until the drill starts it. dev "cpu" and a
    short length rehearse both phases off the card."""

    def __init__(self, torch, dev, length: int = HIST_LENGTH, min_batch_size: int = 100):
        import tempfile

        import numpy as np

        from janus_tpu_torch.aggregator.core import Aggregator, Config
        from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
        from janus_tpu_torch.aggregator.testing import TaskprovHeaderHttp
        from janus_tpu_torch.core.auth import AuthenticationToken
        from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
        from janus_tpu_torch.core.time_util import MockClock
        from janus_tpu_torch.datastore import EphemeralDatastore
        from janus_tpu_torch.messages import Duration, Role, Time
        from janus_tpu_torch.messages import taskprov as tp
        from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder
        from janus_tpu_torch.taskprov import VERIFY_KEY_INIT_LENGTH, PeerAggregator

        self.torch, self.dev = torch, dev
        self.now = 1_700_000_000
        self.tp = 3600
        rng = np.random.default_rng(SEED + 10)
        self.journal_dir = tempfile.TemporaryDirectory(prefix="janus-torch-journal-")
        self.leader_eds = EphemeralDatastore(MockClock(Time(self.now)), engine="pgfake")
        self.helper_eds = EphemeralDatastore(MockClock(Time(self.now)))
        self.leader_eds.datastore.failpoint_scope = "leader"
        self.helper_eds.datastore.failpoint_scope = "helper"
        self.servers, self.aggs = [], []
        try:
            self.leader = Aggregator(self.leader_eds.datastore, self.leader_eds.clock, Config(
                upload_journal_path=self.journal_dir.name, upload_journal_replay_interval_s=0.2), device=dev)
            self.aggs.append(self.leader)
            self.leader_server = DapServer(DapHttpApp(self.leader)).start()
            self.servers.append(self.leader_server)
            self.global_kp = generate_hpke_config_and_private_key(config_id=7)
            self.collector_kp = generate_hpke_config_and_private_key(config_id=200)
            self.peer = PeerAggregator(
                endpoint=self.leader_server.url,
                role=Role.LEADER,
                verify_key_init=rng.integers(0, 256, VERIFY_KEY_INIT_LENGTH, dtype=np.uint8).tobytes(),
                collector_hpke_config=self.collector_kp.config,
                report_expiry_age=None,
                tolerable_clock_skew=Duration(60),
                aggregator_auth_tokens=(AuthenticationToken.random_bearer(),),
                collector_auth_tokens=(AuthenticationToken.random_bearer(),),
            )
            # the helper's caches load its global keys and peers when it is built
            self.helper_eds.datastore.run_tx(lambda tx: tx.put_global_hpke_keypair(self.global_kp, state="active"))
            self.helper_eds.datastore.run_tx(lambda tx: tx.put_taskprov_peer_aggregator(self.peer))
            self.helper = Aggregator(self.helper_eds.datastore, self.helper_eds.clock,
                                     Config(taskprov_enabled=True), device=dev)
            self.aggs.append(self.helper)
            self.helper_server = DapServer(DapHttpApp(self.helper)).start()
            self.servers.append(self.helper_server)
            self.task_config = tp.TaskConfig(
                task_info=b"chip smoke taskprov Prio3Histogram",
                aggregator_endpoints=(self.leader_server.url, self.helper_server.url),
                query_config=tp.QueryConfig(Duration(self.tp), 1, min_batch_size, tp.TaskprovQueryType.TIME_INTERVAL),
                task_expiration=Time(self.now + 365 * 86400),
                vdaf_config=tp.VdafConfig(tp.DpConfig(), tp.VdafType.prio3_histogram(range(1, length))),
            )
            self.inst = self.task_config.vdaf_config.vdaf_type.to_vdaf_instance()
            self.task_id = self.task_config.computed_task_id()
            self.task = TaskBuilder(QueryTypeConfig.time_interval(), self.inst, Role.LEADER).with_(
                task_id=self.task_id,
                leader_aggregator_endpoint=self.leader_server.url,
                helper_aggregator_endpoint=self.helper_server.url,
                vdaf_verify_key=self.peer.derive_vdaf_verify_key(self.task_id),
                collector_hpke_config=self.collector_kp.config,
                aggregator_auth_token=self.peer.primary_aggregator_auth_token(),
                collector_auth_token=self.peer.primary_collector_auth_token(),
                task_expiration=self.task_config.task_expiration,
                min_batch_size=min_batch_size,
                time_precision=Duration(self.tp),
            ).build()
            self.leader_eds.datastore.run_tx(lambda tx: tx.put_task(self.task))
            self.header_http = TaskprovHeaderHttp(self.task_config, timeout=600)
        except BaseException:
            self.close()
            raise

    def advance(self, seconds: int) -> None:
        from janus_tpu_torch.messages import Duration

        for eds in (self.leader_eds, self.helper_eds):
            eds.clock.advance(Duration(seconds))
        self.now += seconds

    def window(self):
        """The start of the current batch interval (one time precision)."""
        from janus_tpu_torch.messages import Duration, Time

        return Time(self.now - 100).to_batch_interval_start(Duration(self.tp))

    def reports(self, n_client: int, n_wire: int, bad_rows, seed: int):
        """n_client measurements to upload through the port Client, and
        n_wire reports made by make_wire_reports (the device shard) sealed
        to the leader's and the helper's global config, `bad_rows` of them
        with their leader measurement share bumped inside the field.
        Returns (client, measurements, wire reports, shard seconds,
        launches of the shard)."""
        import numpy as np

        from janus_tpu_torch.client import Client, ClientParameters
        from janus_tpu_torch.core.hpke import HpkeApplicationInfo, Label, hpke_open, hpke_seal
        from janus_tpu_torch.core.http_client import HttpClient
        from janus_tpu_torch.messages import Duration, InputShareAad, PlaintextInputShare, Report, Role
        from janus_tpu_torch.vdaf.registry import circuit_for
        from janus_tpu_torch.vdaf.testing import make_wire_reports, random_measurements

        meas = random_measurements(self.inst, n_client + n_wire, np.random.default_rng(seed))
        params = ClientParameters(self.task_id, self.leader_server.url, self.helper_server.url, Duration(self.tp))
        client = Client.with_fetched_configs(params, self.inst, HttpClient(timeout=600), clock=self.leader_eds.clock)
        if client.helper_hpke_config != self.global_kp.config:
            raise AssertionError("taskprov: the helper did not advertise its global HPKE config")
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        wire = make_wire_reports(self.inst, meas[n_client:], self.task_id, client.leader_hpke_config,
                                 client.helper_hpke_config, self.window(), seed=seed, shard_chunk=256,
                                 device=self.dev)
        shard_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        keypair = self.task.hpke_keys[0]
        info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER)
        field = circuit_for(self.inst).FIELD
        size = field.ENCODED_SIZE
        for i in bad_rows:
            src = wire[i]
            aad = InputShareAad(self.task_id, src.metadata, src.public_share).to_bytes()
            payload = bytearray(PlaintextInputShare.from_bytes(
                hpke_open(keypair, info, src.leader_encrypted_input_share, aad)).payload)
            payload[:size] = ((int.from_bytes(payload[:size], "little") + 1) % field.MODULUS).to_bytes(size, "little")
            wire[i] = Report(src.metadata, src.public_share, hpke_seal(
                client.leader_hpke_config, info, PlaintextInputShare((), bytes(payload)).to_bytes(), aad,
            ), src.helper_encrypted_input_share)
        return client, meas, wire, shard_s, launches

    def upload(self, reports, threads: int = 8, on_ack=None):
        """PUT each report from `threads` threads through the retry loop;
        returns [(status, start, seconds)] in report order."""
        from concurrent.futures import ThreadPoolExecutor

        from janus_tpu_torch.core.http_client import HttpClient
        from janus_tpu_torch.core.retries import Backoff, retry_http_request
        from janus_tpu_torch.messages import Report

        http = HttpClient(timeout=600)
        uri = self.leader_server.url + "tasks/" + _b64url(self.task_id.data) + "/reports"

        def put(report):
            t0 = time.monotonic()
            status = retry_http_request(lambda: http.put(uri, report.to_bytes(), {"Content-Type": Report.MEDIA_TYPE})
                                        + (http.last_response_headers,), Backoff())[0]
            out = (status, t0, time.monotonic() - t0)
            if on_ack is not None:
                on_ack(out)
            return out

        with ThreadPoolExecutor(max_workers=threads) as pool:
            return list(pool.map(put, reports))

    def client_reports(self, window) -> int:
        return self.leader_eds.datastore.run_tx(lambda tx: tx._c.execute(
            "SELECT COUNT(*) FROM client_reports WHERE client_time >= ? AND client_time < ?",
            (window.seconds, window.seconds + self.tp)).fetchone()[0])

    def driver(self, breakers=None, backoff=None):
        from janus_tpu_torch.aggregator.aggregation_job_driver import (
            AggregationJobDriver,
            AggregationJobDriverConfig,
        )
        from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
        from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers

        cfg = AggregationJobDriverConfig(**({"http_backoff": backoff} if backoff is not None else {}))
        driver = AggregationJobDriver(self.leader_eds.datastore, self.header_http, cfg,
                                      breakers=breakers or OutboundCircuitBreakers(), device=self.dev)
        return driver, JobDriver(JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(), driver.stepper)

    def check_job(self, job, bad_ids):
        """The job finished with its lease released, exactly the bumped
        reports failed with VDAF_PREP_ERROR; returns the finished count."""
        from janus_tpu_torch.messages import PrepareError

        ds = self.leader_eds.datastore
        row = ds.run_tx(lambda tx: tx._c.execute(
            "SELECT state, lease_token IS NULL, lease_attempts FROM aggregation_jobs WHERE job_id = ?",
            (job.job_id.data,)).fetchall())
        if row != [("finished", 1, 0)]:
            raise AssertionError(f"taskprov: job row {row}, not finished with its lease released")
        ras = ds.run_tx(lambda tx: tx.get_report_aggregations_for_job(self.task_id, job.job_id))
        failed = sorted((ra.report_id.data, ra.prepare_error) for ra in ras if ra.state.value == "failed")
        want = sorted((rid, PrepareError.VDAF_PREP_ERROR) for rid in bad_ids)
        if failed != want:
            raise AssertionError(f"taskprov: failed reports {len(failed)} {[f[1] for f in failed][:5]}")
        return sum(1 for ra in ras if ra.state.value == "finished")

    def collect(self, window, want_count: int, truth):
        from janus_tpu_torch.messages import Duration, Interval, Query

        query = Query.time_interval(Interval(window, Duration(self.tp)))
        return collect_batch(self.torch, kernel_counters(), self.task, self.leader_server.url, self.leader_eds,
                             self.collector_kp, query, want_count, truth, helper_http=self.header_http, dev=self.dev)

    def close(self) -> None:
        from janus_tpu_torch import failpoints

        failpoints.clear()
        for srv in self.servers:
            srv.stop()
        for agg in self.aggs:
            agg.close()
        self.leader_eds.cleanup()
        self.helper_eds.cleanup()
        self.journal_dir.cleanup()


def _b64url(b: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def _truth(pair, meas, accept):
    import numpy as np

    return [int(x) for x in np.bincount(np.asarray(meas)[accept], minlength=pair.inst.length)]


def _check_launches(torch, dev, what: str, launches, kernels=("keccak_single_block", "expand_f128")):
    """On the card the path's kernels must have launched and the others not;
    off the card no counter moves."""
    if not _on_card(torch, dev):
        if any(launches.values()):
            raise AssertionError(f"{what}: a CPU run counted kernel launches ({launches})")
        return
    missing = [k for k in kernels if launches[k] == 0]
    stray = [k for k, n in launches.items() if k not in kernels and n != 0]
    if missing or stray:
        raise AssertionError(f"{what}: kernels not launched {missing}, stray {stray} ({launches})")


def phase_taskprov_histogram(pair: TaskprovPair, n_client: int = 8, n_wire: int = 1016, bad_rows=(5, 300, 1000)):
    """The slice's full-width path (see the module docstring, phase 13):
    uploads through the port Client (the helper's global config) and the
    device shard, the leader's creator on the Postgres engine, one job step
    over the header-attaching HTTP client in which the helper opts in, and
    the collection. Returns the record."""
    import numpy as np

    from janus_tpu_torch.aggregator.aggregation_job_creator import AggregationJobCreator
    from janus_tpu_torch.aggregator.core import Aggregator, TaskAggregator
    from janus_tpu_torch.vdaf.feasibility import prepare_row_bytes
    from janus_tpu_torch.vdaf.registry import circuit_for

    torch, dev = pair.torch, pair.dev
    batch = n_client + n_wire
    window = pair.window()
    client, meas, wire, shard_s, shard_launches = pair.reports(n_client, n_wire, bad_rows, SEED + 11)
    _check_launches(torch, dev, "taskprov device shard", shard_launches)
    client_upload_s = []
    for m in meas[:n_client]:
        t0 = time.perf_counter()
        client.upload(int(m))
        client_upload_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    acks = pair.upload(wire)
    upload_s = time.perf_counter() - t0
    if {a[0] for a in acks} != {201} or pair.client_reports(window) != batch:
        raise AssertionError(f"taskprov: uploads {sorted({a[0] for a in acks})}, {pair.client_reports(window)} stored")
    if pair.helper_eds.datastore.run_tx(lambda tx: tx.get_task(pair.task_id)) is not None:
        raise AssertionError("taskprov: the helper held the task before the first aggregate-init")
    pg_statements = len(pair.leader_eds.pg_driver.statements())
    pair.leader_eds.pg_driver.clear_log()

    t0 = time.perf_counter()
    created = AggregationJobCreator(pair.leader_eds.datastore).run_once()
    create_s = time.perf_counter() - t0
    jobs = pair.leader_eds.datastore.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(pair.task_id))
    if created != 1 or len(jobs) != 1:
        raise AssertionError(f"taskprov: the creator made {created} jobs")
    (job,) = jobs

    driver, job_driver = pair.driver()
    counters = kernel_counters()
    on_card = _on_card(torch, dev)
    before = 0
    if on_card:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with MethodSeconds(Aggregator, ["taskprov_opt_in"]) as opt_in_s:
        stepped = job_driver.run_once()
    step_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    step_peak = torch.cuda.max_memory_allocated() - before if on_card else 0
    if stepped != 1 or not driver.step_seconds:
        raise AssertionError(f"taskprov: {stepped} jobs stepped")
    _check_launches(torch, dev, "taskprov job step", launches)
    helper_task = pair.helper_eds.datastore.run_tx(lambda tx: tx.get_task(pair.task_id))
    if helper_task is None or helper_task.hpke_keys or helper_task.vdaf != pair.inst \
            or helper_task.vdaf_verify_key != pair.task.vdaf_verify_key or opt_in_s["taskprov_opt_in"] <= 0:
        raise AssertionError("taskprov: the helper did not opt in to the task it was sent")
    ids = [r.metadata.report_id.data for r in wire]
    finished = pair.check_job(job, [ids[i] for i in bad_rows])
    if finished != batch - len(bad_rows):
        raise AssertionError(f"taskprov: {finished} reports finished")
    circ = circuit_for(pair.inst)
    model = batch * prepare_row_bytes(circ)
    if on_card and step_peak > model:
        raise AssertionError(f"taskprov: the step's peak {step_peak} bytes past the model's {model}")
    accept = np.ones(batch, dtype=bool)
    accept[[n_client + i for i in bad_rows]] = False
    collect = pair.collect(window, int(accept.sum()), _truth(pair, meas, accept))
    if pair.leader.upload_journal.fsyncs != 0:
        raise AssertionError("taskprov: the armed journal synced while the datastore was up")
    return {
        "path": "taskprov-histogram",
        "vdaf": pair.inst.to_dict(),
        "taskprov_vdaf_type": {"prio3_histogram_boundaries": len(pair.task_config.vdaf_config.vdaf_type.buckets)},
        "engines": {"leader": "postgres (pg_fake)", "helper": "sqlite"},
        "batch": batch,
        "client_upload_s": client_upload_s,
        "wire_reports_s": shard_s,
        "shard_launches": shard_launches,
        "upload_s": upload_s,
        "uploads_per_s": n_wire / upload_s,
        "leader_pg_statements_in_upload": pg_statements,
        "create_s": create_s,
        "step_s": step_s,
        "reports_per_s": batch / step_s,
        "stage_s": dict(driver.step_seconds[-1][1]),
        "helper_opt_in_s": opt_in_s["taskprov_opt_in"],
        "helper_stage_s": dict(pair.helper.task_aggregator_for(pair.task_id).stage_seconds),
        "launches": launches,
        "step_peak_bytes": step_peak,
        "model_peak_bytes": model,
        "finished": finished,
        "collect": collect,
        "journal_fsyncs": 0,
    }


def phase_outage_drill(pair: TaskprovPair, n_client: int = 8, n_wire: int = 1016, bad_rows=(7, 400, 900)):
    """A leader outage during uploads and a helper outage during the job's
    first step, on the same task with a fresh batch (see the module
    docstring, phase 14). Returns the record."""
    import logging

    # every injected failure and every spill logs a warning: hundreds in
    # an outage
    quiet = [logging.getLogger(f"janus_tpu_torch.{m}") for m in ("failpoints", "aggregator.report_writer")]
    levels = [q.level for q in quiet]
    for q in quiet:
        q.setLevel(logging.ERROR)
    try:
        return _outage_drill(pair, n_client, n_wire, bad_rows)
    finally:
        for q, level in zip(quiet, levels):
            q.setLevel(level)


def _outage_drill(pair: TaskprovPair, n_client: int, n_wire: int, bad_rows):
    import numpy as np

    from janus_tpu_torch import failpoints
    from janus_tpu_torch.aggregator.aggregation_job_creator import AggregationJobCreator
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.core.circuit_breaker import CircuitBreakerConfig, OutboundCircuitBreakers
    from janus_tpu_torch.core.retries import Backoff

    torch, dev = pair.torch, pair.dev
    batch = n_client + n_wire
    pair.advance(2 * pair.tp)
    window = pair.window()
    sup_kw = dict(probe_interval_s=0.2, down_threshold=3, recover_threshold=2, reconnect_max_interval_s=2.0)
    leader_sup = pair.leader_eds.datastore.start_supervision(**sup_kw)
    helper_sup = pair.helper_eds.datastore.start_supervision(**sup_kw)
    journal, replayer = pair.leader.upload_journal, pair.leader.journal_replayer
    client, meas, wire, shard_s, _ = pair.reports(n_client, n_wire, bad_rows, SEED + 12)
    for m in meas[:n_client]:
        client.upload(int(m))
    t_start = time.monotonic()

    def wait_for(what, cond, timeout_s: float = 30.0):
        deadline = time.monotonic() + timeout_s
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"outage-drill: timed out waiting for {what}")
            time.sleep(0.005)
        return time.monotonic()

    # 1. the leader's outage, midway through the uploads
    half = n_wire // 2
    fsyncs0, appended0 = journal.fsyncs, journal.appended_total
    journal_bytes = [0]

    def on_ack(_ack):
        journal_bytes[0] = max(journal_bytes[0], journal.depth()[1])

    acks = pair.upload(wire[:half])
    failpoints.configure("datastore.connect.leader=error")
    t_fail = time.monotonic()
    try:
        acks += pair.upload(wire[half:], on_ack=on_ack)
        wait_for("the leader's supervisor down", lambda: leader_sup.state == "down")
    finally:
        failpoints.clear()
    t_clear = time.monotonic()
    wait_for("the leader's supervisor up", lambda: leader_sup.state == "up")
    t_empty = wait_for("the journal drained", lambda: journal.depth()[0] == 0)
    if {a[0] for a in acks} != {201}:
        raise AssertionError(f"outage-drill: upload statuses {sorted({a[0] for a in acks})}")
    spilled = journal.appended_total - appended0
    stored = pair.client_reports(window)
    if not spilled or replayer.replayed_fresh != spilled or replayer.replayed_dupes or stored != batch:
        raise AssertionError(f"outage-drill: {spilled} spilled, {replayer.replayed_fresh} replayed fresh,"
                             f" {replayer.replayed_dupes} dupes, {stored} stored of {batch} acked")
    during = [a[2] for a in acks if t_fail <= a[1] < t_clear]
    outside = [a[2] for a in acks if not t_fail <= a[1] < t_clear]
    pair.leader_eds.pg_driver.clear_log()

    # 2. the helper's outage during the job's first step: the helper goes
    # down after the leader's device init, before its aggregate-init
    created = AggregationJobCreator(pair.leader_eds.datastore).run_once()
    jobs = [j for j in pair.leader_eds.datastore.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(pair.task_id))
            if j.state.value == "in_progress"]
    if created != 1 or len(jobs) != 1:
        raise AssertionError(f"outage-drill: the creator made {created} jobs")
    (job,) = jobs
    breakers = OutboundCircuitBreakers(CircuitBreakerConfig(failure_threshold=3, open_cooldown_s=1.0))
    driver, job_driver = pair.driver(breakers, Backoff(initial=0.05, max_interval=0.5, max_elapsed=20.0))
    sheds, step_backs, helper_times = [], [], {}
    app = pair.helper_server.app
    handle = app.handle

    def counting_handle(*a, **kw):
        out = handle(*a, **kw)
        if out[0] == 503:
            sheds.append(out[3].get("Retry-After"))
        return out

    send = AggregationJobDriver._send_init_request_raw
    step_back = AggregationJobDriver.step_back

    def send_during_outage(self, *a, **kw):
        if not helper_times:
            failpoints.configure("datastore.connect.helper=error")
            helper_times["fail"] = time.monotonic()
            wait_for("the helper's supervisor down", lambda: helper_sup.state == "down")
        return send(self, *a, **kw)

    def counting_step_back(self, acquired, reason, delay_s):
        step_backs.append((reason, delay_s))
        return step_back(self, acquired, reason, delay_s)

    app.handle = counting_handle
    AggregationJobDriver._send_init_request_raw = send_during_outage
    AggregationJobDriver.step_back = counting_step_back
    try:
        if job_driver.run_once() != 1:
            raise AssertionError("outage-drill: the first step did not run")
    finally:
        AggregationJobDriver._send_init_request_raw = send
        AggregationJobDriver.step_back = step_back
        failpoints.clear()
    helper_times["clear"] = time.monotonic()
    row = pair.leader_eds.datastore.run_tx(lambda tx: tx._c.execute(
        "SELECT state, lease_token IS NULL, lease_attempts, lease_expiry FROM aggregation_jobs WHERE job_id = ?",
        (job.job_id.data,)).fetchone())
    if not sheds or [r for r, _ in step_backs] != ["circuit_open"] or row[:3] != ("in_progress", 1, 0):
        raise AssertionError(f"outage-drill: {len(sheds)} sheds, step-backs {step_backs}, job row {row}")
    wait_for("the helper's supervisor up", lambda: helper_sup.state == "up")
    # past the step-back's reacquire delay (the leases' clock) and the
    # breaker's cooldown (the host's)
    pair.advance(max(60, row[3] - pair.now + 1))
    time.sleep(max(0.0, 1.05 - (time.monotonic() - helper_times["clear"])))
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    stepped = job_driver.run_once()
    step_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    app.handle = handle
    if stepped != 1:
        raise AssertionError(f"outage-drill: {stepped} jobs stepped after recovery")
    _check_launches(torch, dev, "outage-drill completing step", launches)
    ids = [r.metadata.report_id.data for r in wire]
    finished = pair.check_job(job, [ids[i] for i in bad_rows])
    accept = np.ones(batch, dtype=bool)
    accept[[n_client + i for i in bad_rows]] = False
    if finished != int(accept.sum()):
        raise AssertionError(f"outage-drill: {finished} reports finished")
    collect = pair.collect(window, int(accept.sum()), _truth(pair, meas, accept))

    def first(sup, state, after):
        """When the supervisor first entered `state` after `after` (its log)."""
        return next(t for t, s in sup.transition_log if s == state and t >= after)

    def transitions(sup):
        return [[state, t - t_start] for t, state in sup.transition_log]

    return {
        "path": "outage-drill",
        "vdaf": pair.inst.to_dict(),
        "batch": batch,
        "acked_201": len(acks) + n_client,
        "leader_outage": {
            "spilled": spilled,
            "replayed_fresh": replayer.replayed_fresh,
            "replayed_dupes": replayer.replayed_dupes,
            "journal_fsyncs": journal.fsyncs - fsyncs0,
            "journal_bytes_peak": journal_bytes[0],
            "spill_s": pair.leader.report_writer.stage_seconds["spill"],
            "fail_s": t_fail - t_start,
            "clear_s": t_clear - t_start,
            "fail_to_down_s": first(leader_sup, "down", t_fail) - t_fail,
            "clear_to_up_s": first(leader_sup, "up", t_clear) - t_clear,
            "clear_to_journal_empty_s": t_empty - t_clear,
            "ack_s_during": {"n": len(during), "p50": _percentile(during, 0.5), "p99": _percentile(during, 0.99)},
            "ack_s_outside": {"n": len(outside), "p50": _percentile(outside, 0.5), "p99": _percentile(outside, 0.99)},
        },
        "helper_outage": {
            "sheds_503": len(sheds),
            "retry_after": sorted(set(sheds)),
            "step_backs": [[r, d] for r, d in step_backs],
            "fail_s": helper_times["fail"] - t_start,
            "clear_s": helper_times["clear"] - t_start,
            "fail_to_down_s": first(helper_sup, "down", helper_times["fail"]) - helper_times["fail"],
            "clear_to_up_s": first(helper_sup, "up", helper_times["clear"]) - helper_times["clear"],
            "completing_step_s": step_s,
            "stage_s": dict(driver.step_seconds[-1][1]),
        },
        "transitions_s": {"leader": transitions(leader_sup), "helper": transitions(helper_sup)},
        "launches": launches,
        "finished": finished,
        "collect": collect,
    }


def profile_step(torch, step, args, step_s: float):
    """Device time by kernel over one step (torch.profiler), the share of
    the unprofiled step time `step_s` that the card was busy, and the
    host's self time by operator."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    rows = []
    host = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        rows.append((e.key, dev_us / 1e3, e.count))
        host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    # device kernels only: operator rows (aten::) and runtime API rows
    # (cudaLaunchKernel and the like, no device time) are left out
    kernels_only = [r for r in rows if r[1] > 0 and not r[0].startswith(("aten::", "cuda"))]
    device_ms = sum(r[1] for r in kernels_only)
    return {
        "device_ms_total": device_ms,
        "kernel_launches": sum(r[2] for r in kernels_only),
        "step_s": step_s,
        "device_busy_share": device_ms / 1e3 / step_s,
        "top": [[k, ms, c] for k, ms, c in kernels_only[:15]],
        # host time by operator and runtime call (self time, profiled)
        "top_host": [[k, ms, c] for k, ms, c in host[:12]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import janus_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: janus_tpu_torch is not beside this script ({e})")
        return 3
    from janus_tpu_torch.vdaf.registry import VdafInstance

    dev = torch.device("cuda")
    failed = []
    run_t0 = time.perf_counter()

    def phase(name, fn, *a):
        log(f"chip_smoke: phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*a)
            log(f"chip_smoke: phase {name} passed in {time.perf_counter() - t0:.1f}s")
            return out
        except Exception:
            traceback.print_exc()
            failed.append(name)
            return None

    phase("build", phase_build)
    checks = phase("kernels", phase_kernels, torch, dev) if not failed else None
    paths = {}
    fast = ("keccak_single_block", "expand_f128")
    sumvec = phase(
        "sumvec", run_path, torch, dev, "sumvec", VdafInstance.sum_vec(1000, 16), 1024, (5, 300, 1000),
        fast, 3, 256, 4,
    ) if not failed else None
    if sumvec is not None:
        paths["sumvec"] = sumvec[0]
        sumvec = None  # its arguments leave the card
    runs = (
        ("count", VdafInstance.count(), 8192, (7, 4000, 8000), ("keccak_single_block",), 5, 0, 8, 24),
        ("draft-sumvec", VdafInstance("sumvec", bits=16, length=1000, xof_mode="draft"), 1024, (5, 300, 1000),
         ("keccak_sponge",), 3, 256, 4, 3),
        ("draft-count", VdafInstance("count", xof_mode="draft"), 8192, (7, 4000, 8000), ("keccak_sponge",),
         5, 0, 8, 24),
    )
    for name, inst, batch, bad, kernels_of_path, reps, chunk, small, small_rounds in runs:
        out = phase(
            name, run_path, torch, dev, name, inst, batch, bad, kernels_of_path, reps, chunk, small, small_rounds
        ) if not failed else None
        if out is not None:
            paths[name] = out[0]
            if name == "draft-sumvec":
                step_s = out[0]["two_party_step_s"]
                prof = phase("draft-profile", profile_step, torch, *out[1], sum(step_s) / len(step_s))
                if prof is not None:
                    emit({"profile": {"path": name, "batch": batch, **prof}})
    # long vectors and the last circuits: the north star SumVec(100000, 16)
    # on the streamed query in both XOF modes, and FixedPointVec(1000, 16)
    big = VdafInstance.sum_vec(100_000, 16)
    big_plan = (61_936, 49, 26)
    # (batches halved from 128, 64 and 64: each phase ran past 60 s at those;
    # halved again from 64 and 32 when the sparse phases took the whole
    # script past 480 s: the device shard is most of these phases)
    runs = (
        ("sumvec100k", big, 32, (5, 17, 25), fast, 1, 16, 1, 3, big_plan, 4, True),
        ("draft-sumvec100k", VdafInstance("sumvec", bits=16, length=100_000, xof_mode="draft"), 16, (3, 9, 13),
         ("keccak_sponge",), 1, 16, 0, 24, big_plan, 2, False),
        ("fixedpoint", VdafInstance.fixed_point_vec(1000, 16), 1024, (5, 300, 1000), fast, 3, 256, 4, 24, None, 0,
         False),
    )
    out = None  # the last phase's arguments leave the card before the next
    for name, inst, batch, bad, kernels_of_path, reps, chunk, small, small_rounds, plan, ident, on_card in runs:
        out = phase(
            name, run_path, torch, dev, name, inst, batch, bad, kernels_of_path, reps, chunk, small, small_rounds,
            plan, ident, on_card,
        ) if not failed else None
        if out is not None:
            paths[name] = out[0]
        out = None
    # block-sparse SumVec at the repo's sparse north star (bench.py's config)
    sparse_inst = VdafInstance.sparse_sumvec(16, 1_000_000, 64, 16)
    out = phase("sparse", phase_sparse, torch, dev, sparse_inst, 1024, (5, 300, 1000)) if not failed else None
    if out is not None:
        paths["sparse"] = out
    sponge = phase("sponge", phase_sponge, torch, dev) if not failed else None
    if sponge is not None:
        emit({"sponge": {"batch": 1024, **sponge}})
    serves = {}
    for name, inst, kernels_of_path, batch, bad, chunk, streamed in (
        ("sumvec", VdafInstance.sum_vec(1000, 16), fast, 1024, (5, 300, 1000), 256, False),
        ("draft-sumvec", VdafInstance("sumvec", bits=16, length=1000, xof_mode="draft"), ("keccak_sponge",), 1024,
         (5, 300, 1000), 256, False),
        ("sumvec100k", big, fast, 16, (3, 7, 14), 16, True),  # halved from 64 (past 60 s), then from 32 (the script past 480 s)
    ):
        out = phase(f"serve-{name}", phase_serve, torch, dev, name, inst, batch, bad, kernels_of_path, chunk,
                    streamed, 1 if streamed else 2) if not failed else None
        if out is not None:
            serves[out["path"]] = out
            emit({"serve": out})
    for name, inst, kernels_of_path in (
        ("sumvec", VdafInstance.sum_vec(1000, 16), fast),
        ("draft-sumvec", VdafInstance("sumvec", bits=16, length=1000, xof_mode="draft"), ("keccak_sponge",)),
    ):
        out = phase(f"drive-{name}", phase_drive, torch, dev, name, inst, 1024, (5, 300, 1000),
                    kernels_of_path) if not failed else None
        if out is not None:
            serves[out["path"]] = out
            emit({"drive": out})
    out = phase("upload-drive-sumvec", phase_upload_drive, torch, dev, VdafInstance.sum_vec(1000, 16), 8, 1016,
                (5, 300, 1000), fast) if not failed else None
    if out is not None:
        serves[out["path"]] = out
        emit({"upload_drive": out})
    out = phase("upload-drive-sparse", phase_upload_drive, torch, dev, sparse_inst, 8, 1016, (5, 300, 1000),
                fast) if not failed else None
    if out is not None:
        serves[out["path"]] = out
        emit({"upload_drive": out})
    out = phase("poplar1", phase_poplar1, torch, dev) if not failed else None
    if out is not None:
        serves[out["path"]] = out
        emit({"poplar1": out})
    out = phase("drive-poplar1", phase_drive_poplar1, torch, dev) if not failed else None
    if out is not None:
        serves[out["path"]] = out
        emit({"drive_poplar1": out})
    # the rest of the protocol: a taskprov Prio3Histogram(10000) task on
    # the leader's Postgres engine, then the same task through a database
    # outage on each side
    pair = phase("taskprov-setup", TaskprovPair, torch, dev) if not failed else None
    if pair is not None:
        try:
            out = phase("taskprov-histogram", phase_taskprov_histogram, pair) if not failed else None
            if out is not None:
                serves[out["path"]] = out
                emit({"taskprov_histogram": out})
            out = phase("outage-drill", phase_outage_drill, pair) if not failed else None
            if out is not None:
                serves[out["path"]] = out
                emit({"outage_drill": out})
        finally:
            pair.close()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        log(f"chip_smoke: nvidia-smi failed: {smi.stderr}")
        failed.append("nvidia-smi")
    if failed:
        log(f"chip_smoke: FAILED phases: {failed}")
        return 1

    # each kernel's launches are read from the path that runs it
    main_path = {"keccak_single_block": "sumvec", "expand_f128": "sumvec", "keccak_sponge": "draft-sumvec",
                 "scatter_rows": "sparse"}
    source = {"keccak_single_block": "janus_tpu_torch/csrc/keccak.cu",
              "expand_f128": "janus_tpu_torch/csrc/expand_f128.cu",
              "keccak_sponge": "janus_tpu_torch/csrc/keccak_sponge.cu",
              "scatter_rows": "janus_tpu_torch/csrc/scatter_rows.cu"}
    # kernel 4 replaces an XLA-compiled lax.scan, not a Pallas kernel
    replaces = {"keccak_single_block": "janus_tpu/ops/keccak_pallas.py:236",
                "expand_f128": "janus_tpu/ops/expand_pallas.py:249",
                "keccak_sponge": "janus_tpu/ops/keccak_pallas.py:169",
                "scatter_rows": "janus_tpu/vdaf/prio3_jax.py:458"}
    kernels = []
    for name, cases in checks.items():
        main_case = cases[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source[name],
            "replaces": replaces[name],
            "launches": paths[main_path[name]]["launches"][name],
            "launches_path": main_path[name],
            "launches_by_path": {p: rec["launches"][name] for p, rec in {**paths, **serves}.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": None,
            "cases": cases,
        })
    emit({"kernels": kernels})
    for rec in paths.values():
        emit(rec)
    emit({"run_s": time.perf_counter() - run_t0})
    print(smi.stdout.strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
