#!/usr/bin/env python3
"""Chip smoke test of janus_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which must pass:

  1. build         the four CUDA kernels from csrc/ (one nvcc per source,
                   all started together): the single-block Keccak (its
                   counter-mode and tree-level launches), the fused Field128
                   expansion, the whole draft sponge and the sparse
                   scatter-merge;
  2. kernels       each kernel against its plain PyTorch version on the
                   card, bit for bit, at the shapes of the paths that run it
                   (24 rounds, plus a reduced-round case), with its time, the
                   plain version's time and the least time the card could
                   take (bound); every `ms` is timed call by call, as a
                   caller on the host sees it, and kernels 1 and 4 also
                   with their launches queued ahead (`device_ms`, the
                   device's time alone). Kernel 1 at
                   the leader binder's tree leaves (1,024 x 2,286 nodes, and
                   Histogram(10000)'s 1,024 x 1,429), a level above them, and
                   Poplar1's walk (131,072 states: 5 lanes out, and 2);
                   kernel 2 at the streamed query's
                   tile (128 reports, 8,848 blocks at block offset 25 x
                   8,848) and kernel 3 at draft SumVec(100000, 16)'s
                   152,382-block absorb (64 reports, 24 rounds), held against
                   hashlib.shake_128 on 4 reports, since its plain per-block
                   loop would take hours (its plain_ms is null); kernel 4
                   (the Field128 scatter-add of block-sparse SumVec) at the
                   sparse north star (1,024 reports x 1,024 compact lanes
                   into 1,000,000 positions, block 0 in every report, with
                   its three device kernels' times), the pipelined leader's 256-row
                   chunk and a 64-row bucket with 3 rejected and 24 padding
                   rows (all sentinel);
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
                   fast-mode kernels) at batch 1024, the same checks (no
                   step is profiled any more, to keep the script's time);
                   its small CPU batch runs at 3 Keccak rounds
                   on both sides, since the plain permutation's ~9,000
                   sequential calls at 24 rounds would take minutes on the
                   host (the kernel phase holds the kernel at 24 rounds);
  6. draft-count   Prio3Count in draft mode at batch 8192 (Field64
                   rejection sampling), the same checks;
  6a. sumvec100k   the north star Prio3SumVec(100000, 16) (1.6M Field128
                   inputs a report) at batch 16, fast mode, 3 corrupted,
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
                   16) (BASELINE.json configs[4]), batch 256, fast mode, 3
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
                   query (no GC). The instrumentation (always on) is
                   checked along the way (ObservabilityProbe): a Chrome
                   trace of the drive to a temporary file (its events
                   counted, the file removed), the device-cost ledger's
                   split of the job step beside its wall time, every
                   aggregation and collection job row holding a
                   traceparent and the helper's row and spans the leader
                   job's trace id, both parties' books (admitted 1,024,
                   aggregated 1,021, rejected 3, collected 1,021, every
                   imbalance 0) and the peer divergence 0 from the
                   collection driver's reconciliation, the registry's 107
                   families rendering with no exposition error in either
                   format, the statusz sections, and the cost of a span
                   and of a counter add on this host;
  10b. binaries-sumvec  the deployed process pair, as an operator runs it:
                   `python -m janus_tpu_torch.bin.janus_cli provision-tasks`
                   puts one SumVec(1000, 16) fixed-size task (1,024
                   reports a batch) in each side's SQLite file, then five
                   processes boot at once from .json configs with
                   `device: "cuda:<this card>"` (a helper `bin.aggregator`;
                   the leader's `bin.aggregator`, `aggregation_job_creator`,
                   `aggregation_job_driver` and `collection_job_driver`),
                   each side with its own DATASTORE_KEYS, and each must
                   answer /readyz. With a `POST /debug/profile` window open
                   on the job driver and on the helper, 8 reports are
                   uploaded through the Client and 1,016 made by
                   make_wire_reports are PUT by 8 threads (3 corrupted as
                   in phase 10); the creator packs one job of 1,024, the
                   driver steps it (the leader's job_health statusz says
                   when it finished), and the Collector's current-batch
                   query must give the ground truth over 1,021 reports.
                   Each window's CUDA trace must hold kernels 1 and 2
                   (their symbols in csrc/) and no kernel 3: the kernel
                   counters live in those processes, so the traces show
                   that the binaries ran the hand-written kernels. Every
                   listener is scraped: /metrics and its OpenMetrics form
                   with 0 exposition errors, janus_build_info's backend the
                   card's name, the statusz sections, /alertz,
                   /debug/flight; both parties' /debug/ledger books balance
                   and the leader's peer divergence is 0. Last, SIGTERM:
                   every process exits 0 and logs "shut down" within 30 s.
                   The `binaries` line gives each process's boot seconds
                   (/debug/boot) and time to ready, uploads/s, the job
                   driver's stage seconds (its metrics), the collection's
                   seconds, each profile's kernel counts, each process's
                   device memory, the exit codes and drain seconds, and the
                   phase's seconds;
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
                   the device part (to torch.cuda.synchronize()), the
                   peak device bytes, and one more step under
                   torch.profiler (its device kernels and busy share);
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
  15. pipeline-resident-sumvec  the leader as a janus_tpu operator runs
                   it: a port leader and a port helper over loopback HTTP
                   (as phase 9), two SumVec(1000, 16) tasks with different
                   verify keys, 512 reports each stored at one client time
                   (3 leader shares bumped), 8 jobs of 128. First the
                   merged two-task round (chip_smoke.check_merged_round):
                   128 reports a task through two solo leader rounds and
                   one merged round (per-lane verify keys), then the same
                   for the helper; every out share, seed, verifier share,
                   joint-rand part, mask and prep message must be equal bit
                   for bit (max_abs_err 0), and a merged round must launch
                   kernels 1 and 2 as often as a solo one. Then two
                   JobDriver passes with a StepPipeline, the driver in
                   resident mode (ResidentConfig(enabled=True)): run A, 4
                   jobs, one device-lane worker and double buffering (every
                   job's prestage issued and used); run B, 4 jobs, four
                   workers and four read workers (every prestage declined:
                   those jobs coalesce). Run B's first leader round is held
                   (at most 30 s) until the other three inits have queued
                   behind it, as on a leader whose jobs arrive together, so
                   at least one merged leader round runs through the whole
                   route (the entries, the coalescer, offset DeviceRows
                   views, aggregate_pending, the resident merge, the
                   collection); a run with more than two workers must see
                   one. Counts at 0 just before a run, read just
                   after: kernels 1 and 2 must have launched exactly as
                   often as the rounds seen (leader rounds x a solo leader
                   round's + helper rounds x a helper round's, counted per
                   round, not per job). Each run: one resident merge a job,
                   no classic fallback, the run's peak device bytes under
                   the model (rows in flight x vdaf/feasibility.py's row
                   bytes, plus the pending deltas and the resident slots).
                   Every job finished with its lease released, exactly the
                   bumped reports failed; flush_resident_state("drain")
                   must flush the two slots; each task is collected as in
                   phase 9 and must equal its accepted reports' sum. The
                   line gives per run the job seconds (p50, p95), each
                   stage's seconds, the round sizes on both sides, the
                   prestage outcomes, the merges and each merge's seconds,
                   the launches and the peak beside the model.
  16. pipeline-resident-sparse  the same path for sparse_sumvec(16,
                   1000000, 64, 16) (bench.py:587), one task, 512 reports
                   of 1-16 blocks over 15,625, block 0 in every one, sent as
                   a client would (make_wire_reports) and stored through the
                   leader's upload stages, 4 jobs of 128, one lane. Each
                   job's SparsePendingDeltas merges into the dense
                   1,000,000-element slot through kernel 4: kernel 4 must
                   launch twice a job (the leader's merge, the helper's
                   aggregate); the drained slot is collected at the logical
                   length and must equal numpy's scatter-sum.
  17. device-hang-drill  the card as a failable peer: a port leader and a
                   port helper over loopback, sharing one engine, 3 jobs of
                   128 SumVec(1000, 16) reports. One healthy step
                   (kernels 1 and 2 launch); then the failpoint
                   engine.dispatch=hang,count=1 parks the next step's
                   dispatch on its watchdog worker under a 4 s lease:
                   past the watchdog's hang bound (1 s for this step,
                   inside the lease's budget; 30 s by default) it must
                   raise DeviceHangError, step the job back
                   `device_hang` with the attempt refunded, leave one
                   abandoned thread and quarantine the engine; a step
                   while quarantined must step back `device_quarantined`
                   with no kernel launched (counts at 0 just before, read
                   just after), and the helper must shed a direct
                   aggregate-init 503 with Retry-After; the canary (its
                   delay a minute on the instance, so that nothing
                   restores the engine before) is woken then and must
                   restore the engine; the parked
                   worker is released (it raises) and retires; both jobs
                   then complete and the collection equals the ground
                   truth. Last, a prestaged leader init under an armed
                   deadline on a side stream must run on the watchdog's
                   worker, on the caller's stream, and equal the direct
                   init bit for bit. The line gives the time from the hang
                   to the step-back, from the canary's wake-up to the
                   restore, the
                   probe's seconds, the watchdog's status and the launches;
  18. peer-outage-drill  the helper as a failable peer: the same pair, the
                   leader's task naming a FaultProxy in front of the helper,
                   one job of 256 reports. A `reset` toxic on the request
                   bytes must open the breaker (the step steps back
                   `circuit_open`) and make the PeerHealthTracker park the
                   acquirer: three passes must run no claim transaction.
                   With the toxic cleared the tracker's probe must close
                   the circuit, the job step on the card (kernels 1 and 2)
                   and the collection equal the ground truth. The line
                   gives the claims skipped, the parked seconds, the probes,
                   the steps' seconds and the launches.
  19. mesh         multi-device serving in one process: a mesh of two
                   distinct cards where the machine has two, else
                   [cuda:0, cuda:0] (two shards on one card, the line says
                   `distinct_devices: false`; its times are not a two-GPU
                   figure). mesh-sumvec: SumVec(1000, 16), 1,024 reports with
                   3 corrupted, through a dp = 2 EngineCache: leader init,
                   helper init, both parties' pending sums merged into
                   resident slots (the take must equal numpy's sum of the
                   accepted reports), resident_take and both masked
                   aggregates, every value held against a single-device
                   engine that serves the same inputs just before
                   (max_abs_err 0, the same accepted count). Counts at 0
                   just before the mesh run, read just after: kernels 1 and
                   2 must launch on each shard (launches counted by shard
                   on the lane thread). mesh-sumvec100k, run just after
                   phase 6a on its batch (SumVec(100000, 16), 16 reports,
                   3 corrupted): two devices must choose dp = 1, sp = 2,
                   and sharded_two_party_step must equal that phase's
                   two_party_step. The line gives both engines' seconds in
                   turns (single, mesh, mesh, single), the step's, the lane's status
                   and the two parts' seconds;
  20. fleet-drill  the leader as a fleet of two replicas over one
                   datastore, after the drills of phases 17 and 18 (run
                   before phase 19 in the script): two time-interval
                   SumVec(1000, 16) tasks of 256 reports (2 corrupted each;
                   cut from 512 when the phase alone took 26 s on an H100),
                   task A in creator shard 0 of 2 and B in shard 1 (ids
                   drawn from the seed), a MockClock for every wait.
                   Creator replica a (FleetConfig shard 0 of 2, steal after
                   5 s; replica b is dead) must create A's 2 jobs of 128 on
                   its first sweep and B's only after stealing B, at most
                   10 mock seconds after B's backlog appeared. Two
                   AggregationJobDrivers with acquirer(fleet=), a (shard 0)
                   and b (shard 1), steal fence 30 s: b claims one shard-1
                   job, is stopped, and the armed helper.aggregate (one
                   hit) fails its step, so JobDriver's drain releaser hands
                   it back (shard_key -1, attempt refunded); a must then
                   claim its own shard's jobs and the handed-back job
                   without a clock step (counted as a hand-back, not a
                   steal) and, 31 mock seconds on, the rest of shard 1,
                   each counted as a steal, the sets derived from the jobs'
                   stored shard keys. While a job is held,
                   get_lease_holders must name the replica stepping it.
                   Each of a's steps must launch kernels 1 and 2 (counts at
                   0 just before, read just after; their sum is the
                   phase's launches), every job finishes and both
                   collections equal numpy's sum of the accepted reports.
                   The line gives the jobs per task, the claims by replica
                   and kind, the creator's steal latency in mock seconds,
                   the hand-back's claim latency (mock and wall seconds),
                   the failpoint's hits, the step seconds (p50, max), the
                   launches and the phase's seconds;

Output: JSON lines (build, the
sponge chains, one serve line per XOF mode with the seconds of each
stage of the request, one drive line per XOF mode with the seconds of
each stage of the leader's step and the helper's request in it, the
upload-drive lines with the upload, ingest, create and step seconds, and
in the drive-sumvec and upload-drive lines a "collect" record (the
seconds of create, the driver's gather, sum, http_aggregate_share and
store, the helper's handle_aggregate_share, poll and unshard, and GC,
with GC's seconds by side and by delete; the device bytes before and the
peak during the collection step), the poplar1 and drive_poplar1 lines,
the taskprov_histogram and outage_drill lines, the two pipeline_resident
lines, the device_hang_drill and peer_outage_drill lines, the fleet_drill
line, the mesh line, the observability line after upload-drive-sumvec's
and the binaries line after it,
the kernels,
one line per path, the run's wall time), then the card's
name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}.
Without CUDA, or without the package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

SEED = 20261016
VERIFY_KEY = bytes(range(32, 48))
VERIFY_KEY_B = bytes(range(48, 64))  # the second task of the cross-task path
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


def time_queued(torch, fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card with the launches queued
    ahead: the stream first sleeps long enough for the host to enqueue
    all reps, so the time is the device's alone, not the host's pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000 * reps)  # ~0.1 ms a rep at the H100's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(torch, fn, reps: int) -> dict:
    """Mean device milliseconds a call of fn() spends in each kernel, by
    the profiler (a wrapper's launch may run several kernels)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if dev_us > 0 and not e.key.startswith(("aten::", "cuda")):
            out[e.key.split("(")[0].replace("void ", "")] = dev_us / 1e3 / reps
    return out


def kernel_case(torch, run, plain, reps: int, n_ops: float, nbytes: float, info: dict) -> dict:
    """A kernel against its plain version on the same inputs: max_abs_err,
    its time call by call as a caller sees it (`ms`, the yardstick of
    every kernel's rows), its device time with the launches queued ahead
    (`device_ms`), the plain version's time (a second, warm call), the
    bound, and the seconds the case took (`case_s`)."""
    t0 = time.perf_counter()
    got, want = run(), plain()
    torch.cuda.synchronize()
    err = max_abs_err(torch, got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,))
    del got, want
    ms = time_cuda(torch, run, reps)
    device_ms = time_queued(torch, run, reps)
    plain_ms = time_cuda(torch, plain, reps=1, warmup=0)
    b_ms, b_by = bound_ms(n_ops, nbytes)
    return {**info, "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound": b_ms / ms if ms else None, "case_s": time.perf_counter() - t0}


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over unsigned 64-bit words (0 when identical);
    raises where the values' counts or shapes differ."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} values against {len(want)}")
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shapes differ: {tuple(g.shape)} against {tuple(w.shape)}")
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

    from janus_tpu_torch.ops import expand_cuda
    from janus_tpu_torch.vdaf.registry import VdafInstance

    rng = np.random.default_rng(SEED)

    def lanes(shape):
        a = rng.integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)
        return torch.from_numpy(a.view(np.int64)).to(dev)

    batch, blocks, length = 1024, 2286, 16000  # SumVec(1000, 16): 16000 F128 elements a report
    results = {"keccak_sponge": []}  # the path's kernel first

    results["keccak_single_block"] = kernel1_cases(torch, dev, lanes, batch, length, HIST_LENGTH,
                                                   POPLAR1_BATCH * POPLAR1_PREFIXES)

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
    results["scatter_rows"] = check_scatter(torch, dev, rng, VdafInstance.sparse_sumvec(16, 1_000_000, 64, 16))
    bad = [c for cs in results.values() for c in cs if c["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return results


def kernel1_cases(torch, dev, lanes, batch: int, length: int, hist_length: int, walk_states: int):
    """Kernel 1 against its plain version, one launch a batch of states in
    either entry: the leader binder's tree leaf level at SumVec(1000, 16)
    (over an id, a nonce and 2 x length share lanes: batch x 2,286 nodes
    at length 16,000, the path's largest launch), a level above it,
    Poplar1's counter-mode
    walk (walk_states states: 5 lanes out for extend, 2 for convert),
    Histogram(10000)'s tree leaves (batch x 1,429) and a reduced-round
    stream at an offset. lanes(shape): random int64 lanes on dev."""
    from janus_tpu_torch.ops import keccak_cuda
    from janus_tpu_torch.vdaf.poplar1_device import _DST_CONVERT, _DST_EXTEND

    def tree_case(name, parts, lanes_n, level, rounds, reps):
        n = keccak_cuda.tree_nodes(lanes_n)
        run = lambda: keccak_cuda.keccak_tree_level(parts, lanes_n, batch, level, 8 * lanes_n, dev, rounds=rounds)  # noqa: E731
        plain = lambda: keccak_cuda.keccak_tree_level_plain(parts, lanes_n, batch, level, 8 * lanes_n, dev, rounds=rounds)  # noqa: E731
        return kernel_case(torch, run, plain, reps, n_ops=batch * n * rounds * KECCAK_OPS_PER_ROUND,
                           nbytes=batch * lanes_n * 8 + batch * n * 16,
                           info={"case": name, "reports": batch, "nodes": n, "lanes": lanes_n, "level": level,
                                 "rounds": rounds})

    def ctr_case(name, parts, p, rows, nblocks, out_lanes, rounds, reps, offset=0):
        run = lambda: keccak_cuda.keccak_ctr_blocks(parts, p, rows, nblocks, out_lanes, dev, ctr_offset=offset, rounds=rounds)  # noqa: E731
        plain = lambda: keccak_cuda.keccak_ctr_blocks_plain(parts, p, rows, nblocks, out_lanes, dev, ctr_offset=offset, rounds=rounds)  # noqa: E731
        varying = sum(c.shape[1] for _, c in parts if not isinstance(c, bytes))
        return kernel_case(torch, run, plain, reps, n_ops=rows * nblocks * rounds * KECCAK_OPS_PER_ROUND,
                           nbytes=rows * varying * 8 + rows * nblocks * out_lanes * 8,
                           info={"case": name, "states": rows * nblocks, "out_lanes": out_lanes, "rounds": rounds,
                                 "ctr_offset": offset})

    cases = []
    binder = [(0, bytes(8)), (1, lanes((batch, 2))), (3, lanes((batch, 2 * length)))]
    cases.append(tree_case("sumvec tree leaves", binder, 3 + 2 * length, 0, 24, 10))
    cases.append(tree_case("sumvec tree leaves, 3 rounds", binder, 3 + 2 * length, 0, 3, 10))
    digs = keccak_cuda.keccak_tree_level(binder, 3 + 2 * length, batch, 0, 8 * (3 + 2 * length), dev)
    cases.append(tree_case("sumvec tree level 1", [(0, digs.reshape(batch, -1))], 2 * digs.shape[1], 1, 24, 20))
    del binder, digs
    n = walk_states
    seeds = lanes((n, 2))
    cases.append(ctr_case("poplar1 leaf walk, extend", [(0, _DST_EXTEND), (2, seeds)], 4, n, 1, 5, 24, 50))
    cases.append(ctr_case("poplar1 leaf walk, convert", [(0, _DST_CONVERT), (2, seeds)], 4, n, 1, 2, 24, 50))
    del seeds
    hist = [(0, bytes(8)), (1, lanes((batch, 2))), (3, lanes((batch, 2 * hist_length)))]
    cases.append(tree_case("histogram10000 tree leaves", hist, 3 + 2 * hist_length, 0, 24, 10))
    del hist
    prefix_parts = [(0, bytes(16)), (2, lanes((batch, 2))), (4, lanes((1, 1))), (5, lanes((batch, 2)))]
    cases.append(ctr_case("stream at an offset, 3 rounds", prefix_parts, 7, batch, 64, 21, 3, 20, offset=5))
    return cases


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


def check_scatter(torch, dev, rng, inst, rows=(1024, 256, 64)):
    """Kernel 4 against its plain version on the card: the north star (1,024
    reports x 1,024 compact lanes into 1,000,000 positions, blocks uniform
    over 15,625 with block 0 in every report), with its three device
    kernels' times; the pipelined leader's chunk (256 reports); then a
    64-row bucket with 3 rejected rows and 24 padding rows (all
    sentinel)."""
    import numpy as np

    from janus_tpu_torch.ops import scatter_cuda
    from janus_tpu_torch.vdaf.registry import circuit_for
    from janus_tpu_torch.vdaf.wire import flat_scatter_indices

    circ = circuit_for(inst)
    L = circ.logical_length
    cases = []
    for name, b, dead in (("north star, hot block 0", rows[0], ()), ("pipelined leader's chunk", rows[1], ()),
                          ("rejected and padding rows", rows[2], (3, 17, 30, *range(40, 64)))):
        _, bi, _ = sparse_measurements(inst, b, int(rng.integers(0, 2**31)))
        bi[list(dead)] = -1
        flat = flat_scatter_indices(bi, circ)
        idx = torch.from_numpy(flat).to(dev)
        lo = rng.integers(0, 2**64 - 1, size=flat.shape, dtype=np.uint64, endpoint=True)
        hi = rng.integers(0, (F128 >> 64) - 1, size=flat.shape, dtype=np.uint64)  # reduced: below p's high word
        vals = tuple(torch.from_numpy(a.view(np.int64)).to(dev) for a in (lo, hi))
        acc = tuple(torch.from_numpy(rng.integers(0, (F128 >> 64) - 1, size=L, dtype=np.uint64).view(np.int64)).to(dev)
                    for _ in range(2))
        live = int((flat < L).sum())
        # bytes: live values and every index read once, acc read once and
        # written once; operations: one Field128 add (8 32-bit ops) a live lane
        case = kernel_case(
            torch, lambda: scatter_cuda.scatter_rows(acc, vals, idx), lambda: scatter_cuda.scatter_rows_plain(acc, vals, idx),
            20, n_ops=8 * live, nbytes=live * 16 + flat.size * 4 + 2 * L * 16,
            info={"case": name, "reports": b, "compact_lanes": flat.shape[1], "logical_length": L, "live_lanes": live},
        )
        if name.startswith("north star"):  # the launch's three kernels (copy, accumulate, finalize)
            case["device_ms_by_kernel"] = device_ms_by_kernel(torch, lambda: scatter_cuda.scatter_rows(acc, vals, idx),
                                                              20)
        cases.append(case)
        del vals, acc, idx
    return cases


def phase_sparse(torch, dev, inst, batch: int, bad_rows, reps: int = 1, small_batch: int = 4):
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
    (the step function, its arguments, the first step's outputs)). `kernels` must launch during the
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
    return rec, (step, args, (agg0, agg1, count))


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


class ObservabilityProbe:
    """The observability checks of one served drive (upload-drive-sumvec):
    every check reads what the instrumentation recorded, and adds no
    synchronization or launch to the drive it watches. `start()` before
    the uploads, `step_begin()` / `step_end(step_s)` around the job step,
    `check_trace(...)` after it, `check_ledger(...)` after the
    collection, `finish()` last; any failed check raises."""

    SPAN_LOOPS = 20_000
    COUNTER_LOOPS = 200_000

    def __init__(self, chrome_path: str):
        self.chrome_path = chrome_path
        self._chrome = None
        self.record: dict = {}

    @staticmethod
    def _span_counts() -> dict:
        from janus_tpu_torch import trace

        return {n: d["count"] for n, d in trace.flight_recorder().status()["names"].items()}

    @staticmethod
    def _cost_entries() -> dict:
        from janus_tpu_torch.profiler import DEVICE_COST

        return {(e["vdaf"], e["op"], e["bucket"]): e for e in DEVICE_COST.status()["entries"]}

    def abandon(self) -> None:
        """Close the Chrome trace of a drive that failed."""
        if self._chrome is not None:
            self._chrome.__exit__(None, None, None)
            self._chrome = None

    def start(self) -> None:
        from janus_tpu_torch import trace

        self._names0 = self._span_counts()
        self._chrome = trace.scoped_chrome_trace(self.chrome_path)
        self._chrome.__enter__()

    def step_begin(self) -> None:
        self._cost0 = self._cost_entries()

    def step_end(self, step_s: float) -> None:
        """The device-cost ledger's split of the job step (helper_init,
        leader_init and aggregate; both parties run in this process),
        beside the step's wall time. On the card a dispatch's `execute`
        is its enqueue: the queued kernels' time lands in the `d2h` of
        the fetch that waits for them."""
        from janus_tpu_torch.profiler import COST_PHASES

        ops: dict = {}
        for key, e in self._cost_entries().items():
            if key[1] not in ("helper_init", "leader_init", "aggregate"):
                continue
            e0 = self._cost0.get(key, {})
            op = ops.setdefault(key[1], {"dispatches": 0, "rows": 0, "buckets": [], **{f"{p}_s": 0.0 for p in COST_PHASES}})
            d = e["dispatches"] - e0.get("dispatches", 0)
            if d or any(e[f"{p}_s"] != e0.get(f"{p}_s", 0.0) for p in COST_PHASES):
                op["buckets"].append(key[2])
            op["dispatches"] += d
            op["rows"] += e["rows"] - e0.get("rows", 0)
            for p in COST_PHASES:
                op[f"{p}_s"] += e[f"{p}_s"] - e0.get(f"{p}_s", 0.0)
        if set(ops) != {"helper_init", "leader_init", "aggregate"} or any(o["dispatches"] < 1 for o in ops.values()):
            raise AssertionError(f"observability: the step's device-cost ops {ops}")
        total = sum(o[f"{p}_s"] for o in ops.values() for p in COST_PHASES)
        self.record["device_cost"] = {"ops": ops, "phases_sum_s": total, "request_wall_s": step_s,
                                      "queued_time_in": "d2h"}

    def check_trace(self, leader_ds, helper_ds) -> None:
        """Every aggregation job row of both parties carries a traceparent,
        the helper's with the leader job's trace id, and the helper's
        spans in the recorder carry it too."""
        from janus_tpu_torch import trace

        def contexts(ds, table):
            return ds.run_tx(lambda tx: [r[0] for r in tx._c.execute(f"SELECT trace_context FROM {table}").fetchall()])

        leader_ctx = contexts(leader_ds, "aggregation_jobs")
        helper_ctx = contexts(helper_ds, "aggregation_jobs")
        if not leader_ctx or any(trace.trace_id_of(c) is None for c in leader_ctx + helper_ctx):
            raise AssertionError(f"observability: job trace contexts {leader_ctx} / {helper_ctx}")
        job_trace = trace.trace_id_of(leader_ctx[0])
        if [trace.trace_id_of(c) for c in helper_ctx] != [job_trace]:
            raise AssertionError("observability: the helper's job row has another trace than the leader's")
        recent = trace.flight_recorder().snapshot(recent_limit=512)["recent"]
        helper_spans = sorted({s["name"] for s in recent if s["trace_id"] == job_trace
                               and (s["name"].startswith("helper.") or s["name"] == "dap.aggregate_init")})
        if "dap.aggregate_init" not in helper_spans or "helper.write_tx" not in helper_spans:
            raise AssertionError(f"observability: the helper's spans under the job's trace: {helper_spans}")
        self.record["trace"] = {"job_trace_id": job_trace, "helper_job_trace_ok": True,
                                "helper_spans_in_job_trace": helper_spans}

    def check_ledger(self, leader_ds, helper_ds, task_id, want_admitted: int, want_aggregated: int,
                     want_rejected: dict) -> None:
        """Both parties' books after the collection (evaluated now, grace
        0): the counts, every imbalance 0, the collection job's trace
        context set, and the peer divergence the leader's collection
        driver recorded, which must be 0."""
        from janus_tpu_torch import ledger, trace
        from janus_tpu_torch.metrics import task_id_label

        coll = leader_ds.run_tx(lambda tx: [r[0] for r in tx._c.execute(
            "SELECT trace_context FROM collection_jobs").fetchall()])
        if not coll or any(trace.trace_id_of(c) is None for c in coll):
            raise AssertionError(f"observability: collection job trace contexts {coll}")
        label = task_id_label(task_id.data)
        books = {}
        for side, ev in (("leader", ledger.installed_ledger()),
                         ("helper", ledger.LedgerEvaluator(helper_ds, ledger.LedgerConfig(grace_s=0.0)))):
            t = ev.evaluate_once()["tasks"][label]
            books[side] = {k: t[k] for k in ("admitted", "aggregated", "rejected", "collected", "lost", "imbalance")}
            if (t["admitted"], t["aggregated"], t["collected"], t["lost"]) != (
                    want_admitted, want_aggregated, want_aggregated, 0) or t["rejected"] != want_rejected \
                    or any(t["imbalance"].values()):
                raise AssertionError(f"observability: the {side}'s books {books[side]}")
        peer = ledger.installed_ledger().document()["tasks"][label]["peer"]
        if peer is None or peer["divergence"] != 0 or peer["batches_compared"] < 1:
            raise AssertionError(f"observability: the peer reconciliation {peer}")
        self.record["ledger"] = {**books, "peer_divergence": peer["divergence"],
                                 "batches_compared": peer["batches_compared"], "collection_trace_ok": True}

    def finish(self) -> dict:
        """Close the Chrome trace and count its events; the spans by name
        of the drive; the registry's families and the exposition errors
        in both formats; the statusz sections; and the cost of a span
        and of a counter add on this host (no trace writer installed)."""
        from janus_tpu_torch import exposition, metrics, statusz, trace

        self.abandon()
        with open(self.chrome_path) as f:
            events = [e for e in json.load(f) if e]
        names1 = self._span_counts()
        spans = {n: c - self._names0.get(n, 0) for n, c in sorted(names1.items()) if c - self._names0.get(n, 0)}
        text = metrics.REGISTRY.render()
        om = metrics.REGISTRY.render(openmetrics=True)
        errors = exposition.validate_exposition(text)
        om_errors = exposition.validate_exposition(om, openmetrics=True)
        lint = exposition.lint_metric_names(exposition.registry_names_by_type(metrics.REGISTRY))
        if errors or om_errors or lint:
            raise AssertionError(f"observability: exposition errors {errors[:5]} {om_errors[:5]} {lint[:5]}")
        t0 = time.perf_counter_ns()
        for _ in range(self.SPAN_LOOPS):
            with trace.span("observability.span_cost"):
                pass
        span_ns = (time.perf_counter_ns() - t0) / self.SPAN_LOOPS
        probe = metrics.Counter("janus_observability_probe_total")  # not registered
        t0 = time.perf_counter_ns()
        for _ in range(self.COUNTER_LOOPS):
            probe.add(1, op="probe")
        add_ns = (time.perf_counter_ns() - t0) / self.COUNTER_LOOPS
        sections = sorted(k for k in statusz.status_snapshot() if k != "generated_at")
        for want in ("engine_cache", "resident_accumulators", "mesh", "device_watchdog", "ingest", "failpoints",
                     "fleet", "ledger", "profile", "device_cost"):
            if want not in sections:
                raise AssertionError(f"observability: statusz has no {want} section ({sections})")
        if len(metrics.REGISTRY.metrics_list()) != 107:
            raise AssertionError(f"observability: {len(metrics.REGISTRY.metrics_list())} families, not 107")
        self.record.update({
            "families": len(metrics.REGISTRY.metrics_list()),
            "exposition_errors": len(errors),
            "openmetrics_errors": len(om_errors),
            "lint_errors": len(lint),
            "spans": spans,
            "chrome_trace_events": len(events),
            "statusz_sections": sections,
            "span_ns": span_ns,
            "counter_add_ns": add_ns,
        })
        return self.record


def phase_upload_drive(torch, dev, inst, n_client: int, n_wire: int, bad_rows, kernels, threads: int = 8,
                       observe: bool = False):
    """The leader's intake end to end (see the module docstring, phase
    10): reports uploaded over loopback HTTP to a port leader, admitted,
    decoded, opened, validated and group-committed by its ingest
    pipeline, packed into one fixed-size batch by the creator, and
    stepped by the job driver against a port helper, then collected by a
    current-batch query; returns the record. With `observe`, an
    ObservabilityProbe watches the drive and the record carries its
    `observability` record."""
    import dataclasses
    import json as json_mod
    import os
    import tempfile
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
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.retries import Backoff, retry_http_request
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.datastore.store import Crypter, Transaction
    from janus_tpu_torch.messages import (
        FixedSizeQuery,
        PartialBatchSelector,
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

    from janus_tpu_torch import ledger

    leader_eds = EphemeralDatastore(MockClock(Time(now)))
    helper_eds = EphemeralDatastore(MockClock(Time(now)))
    helper = Aggregator(helper_eds.datastore, helper_eds.clock, device=dev)
    leader = Aggregator(leader_eds.datastore, leader_eds.clock, device=dev)
    helper_server = DapServer(DapHttpApp(helper)).start()
    leader_server = DapServer(DapHttpApp(leader)).start()
    probe = None
    if observe:
        fd, chrome_path = tempfile.mkstemp(prefix="janus-chrome-", suffix=".json")
        os.close(fd)
        probe = ObservabilityProbe(chrome_path)
        probe.start()
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
        field = circuit_for(inst).FIELD
        size = field.ENCODED_SIZE

        def reseal(src, md, mutate):
            return _reseal(task, client.leader_hpke_config, src, md, mutate)

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
        if probe is not None:
            probe.step_begin()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with MethodSeconds(EngineCache, ["aggregate_sparse"]) as agg_sparse_s, \
                MethodSeconds(Field128, ["encode_vec"]) as encode_s:
            stepped = job_driver.run_once()
        step_s = time.perf_counter() - t0
        if probe is not None:
            probe.step_end(step_s)
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
        if probe is not None:
            probe.check_trace(leader_eds.datastore, helper_eds.datastore)
            # the leader's books, and its collection driver's peer
            # reconciliation, read the installed evaluator
            ledger.install_ledger(leader_eds.datastore, ledger.LedgerConfig(grace_s=0.0))

        # 6. collection of the filled batch by a current-batch query
        with MethodSeconds(Field128, ["decode_vec"]) as decode_s:
            collect = collect_batch(
                torch, counters, task, leader_server.url, leader_eds, collector_kp,
                Query.fixed_size(FixedSizeQuery(FixedSizeQuery.CURRENT_BATCH)), finished, truth, batch_id=batch_id,
                dev=dev,
            )
        observability = None
        if probe is not None:
            probe.check_ledger(leader_eds.datastore, helper_eds.datastore, task.task_id, batch, finished,
                               {"vdaf_prep_error": len(bad_rows)})
            observability = probe.finish()
            probe = None
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
            "uploads_per_s": (n_wire - 1) / upload_s,
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
            **({"observability": observability} if observability is not None else {}),
        }
    finally:
        if observe:
            ledger.uninstall_ledger()
            if probe is not None:
                probe.abandon()
            os.unlink(chrome_path)
        leader_server.stop()
        helper_server.stop()
        leader.close()
        leader_eds.cleanup()
        helper_eds.cleanup()


BINARY_SERVICES = ("helper", "leader", "creator", "agg_driver", "col_driver")
# the kernel symbols of rows 1 and 2 of PERF.md's table (csrc/keccak.cu,
# csrc/expand_f128.cu), and of the kernels the fast path must not launch
TRACE_KERNELS = {
    "keccak_single_block": ("keccak_ctr_kernel", "keccak_tree_kernel"),
    "expand_f128": ("expand_f128_kernel",),
    "keccak_sponge": ("keccak_sponge_kernel",),
}


def _reseal(task, leader_hpke_config, src, md, mutate):
    """`src` as `md`, its leader payload changed by mutate(bytearray) and
    sealed again: the client's seal of another share."""
    from janus_tpu_torch.core.hpke import HpkeApplicationInfo, Label, hpke_open, hpke_seal
    from janus_tpu_torch.messages import InputShareAad, PlaintextInputShare, Report, Role

    info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER)
    payload = bytearray(PlaintextInputShare.from_bytes(hpke_open(
        task.hpke_keys[0], info, src.leader_encrypted_input_share,
        InputShareAad(task.task_id, src.metadata, src.public_share).to_bytes(),
    )).payload)
    mutate(payload)
    return Report(md, src.public_share, hpke_seal(
        leader_hpke_config, info, PlaintextInputShare((), bytes(payload)).to_bytes(),
        InputShareAad(task.task_id, md, src.public_share).to_bytes(),
    ), src.helper_encrypted_input_share)


def _http(url: str, method: str = "GET", timeout: float = 60.0):
    """(status, body) of one request to a health listener, whatever the
    status, the whole body."""
    from janus_tpu_torch.core.http_client import fetch_any_status

    return fetch_any_status(url, method, b"" if method == "POST" else None, timeout=timeout, max_bytes=1 << 30)


def trace_kernel_counts(path: str) -> dict:
    """Kernel launches by TRACE_KERNELS row in a torch.profiler Chrome
    trace (the events of category `kernel`), and every kernel name's count."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e.get("name", "")] = by_name.get(e.get("name", ""), 0) + 1
    rows = {k: sum(c for n, c in by_name.items() if any(s in n for s in syms)) for k, syms in TRACE_KERNELS.items()}
    ours = {n: c for n, c in by_name.items() if any(s in n for syms in TRACE_KERNELS.values() for s in syms)}
    return {"rows": rows, "kernel_events": sum(by_name.values()), "distinct_kernels": len(by_name),
            "by_symbol": ours}


def phase_binaries(torch, dev, inst, n_client: int, n_wire: int, bad_rows, profile_s: float = 25.0,
                   base_port: int = 27300):
    """The deployed process pair (see the module docstring, phase 10b):
    janus_cli provisions one task on each side, the five binaries boot
    from .json configs on `dev`, the reports are uploaded over HTTP with
    two profile windows open (the leader's job driver and the helper),
    the collection must equal the ground truth, every listener is
    scraped, and every process drains on SIGTERM. Returns the record."""
    import base64
    import dataclasses
    import os
    import secrets
    import shutil
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from janus_tpu_torch import exposition
    from janus_tpu_torch.client import Client, ClientParameters
    from janus_tpu_torch.collector import CollectionJobNotReady, Collector, CollectorParameters
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.retries import Backoff, retry_http_request
    from janus_tpu_torch.messages import FixedSizeQuery, Query, Report, Role, Time
    from janus_tpu_torch.metrics import task_id_label
    from janus_tpu_torch.task import QueryTypeConfig, Task, TaskBuilder
    from janus_tpu_torch.vdaf.registry import circuit_for
    from janus_tpu_torch.vdaf.testing import make_wire_reports, random_measurements

    phase_t0 = time.perf_counter()
    repo = Path(__file__).resolve().parent
    batch = n_client + n_wire
    on_card = dev.type == "cuda"
    device = f"cuda:{torch.cuda.current_device()}" if on_card else "cpu"
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    health = {name: base_port + i for i, name in enumerate(BINARY_SERVICES)}
    dap = {"helper": base_port + 10, "leader": base_port + 11}
    url = {side: f"http://127.0.0.1:{p}/" for side, p in dap.items()}
    tmp = Path(tempfile.mkdtemp(prefix="janus-binaries-"))
    keys = {side: base64.urlsafe_b64encode(secrets.token_bytes(16)).decode().rstrip("=") for side in dap}
    db = {side: str(tmp / f"{side}.sqlite") for side in dap}
    env = {side: dict(os.environ, PYTHONPATH=str(repo), DATASTORE_KEYS=keys[side]) for side in dap}
    procs: dict = {}
    profile_dirs: list = []
    try:
        # 1. the tasks, provisioned through janus_cli on each side
        collector_kp = generate_hpke_config_and_private_key(config_id=7)
        built = TaskBuilder(QueryTypeConfig.fixed_size(max_batch_size=batch), inst, Role.LEADER).with_(
            vdaf_verify_key=VERIFY_KEY, aggregator_auth_token=AuthenticationToken.random_bearer(),
            collector_auth_token=AuthenticationToken.random_bearer(), leader_aggregator_endpoint=url["leader"],
            helper_aggregator_endpoint=url["helper"], collector_hpke_config=collector_kp.config, min_batch_size=1,
        ).build()
        task = Task.from_dict(built.to_dict())
        helper_task = Task.from_dict(dataclasses.replace(
            built, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
        ).to_dict())
        t0 = time.perf_counter()
        provision = {}
        for side, t in (("leader", task), ("helper", helper_task)):
            tasks_file = tmp / f"{side}_tasks.json"
            tasks_file.write_text(json.dumps([t.to_dict()]))
            provision[side] = subprocess.Popen(
                [sys.executable, "-m", "janus_tpu_torch.bin.janus_cli", "provision-tasks", str(tasks_file),
                 "--database", db[side], f"--datastore-keys={keys[side]}"],
                cwd=str(repo), env=env[side], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        # 2. one .json config a process, all five booted at once, while
        # janus_cli provisions (a binary reads its tasks when it serves)
        common = {"device": device, "health_sampler_interval_secs": 2, "flight": {"interval_secs": 2},
                  "slo": {"evaluation_interval_secs": 2}}
        driver = {"min_job_discovery_delay_secs": 0.1, "max_job_discovery_delay_secs": 0.5,
                  "worker_lease_duration_secs": 120}
        specs = {
            "helper": ("aggregator", "helper", {"listen_address": f"127.0.0.1:{dap['helper']}"}),
            "leader": ("aggregator", "leader", {"listen_address": f"127.0.0.1:{dap['leader']}"}),
            "creator": ("aggregation_job_creator", "leader", {
                "aggregation_job_creation_interval_secs": 0.5, "min_aggregation_job_size": batch,
                "max_aggregation_job_size": batch}),
            "agg_driver": ("aggregation_job_driver", "leader", driver),
            "col_driver": ("collection_job_driver", "leader", driver),
        }
        spawned = {}
        for name, (binary, side, extra) in specs.items():
            cfg = tmp / f"{name}.json"
            cfg.write_text(json.dumps({"database": {"url": db[side]},
                                       "health_check_listen_address": f"127.0.0.1:{health[name]}", **common,
                                       **extra}))
            logf = open(tmp / f"{name}.log", "wb")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"janus_tpu_torch.bin.{binary}", "--config-file", str(cfg)],
                cwd=str(repo), env=env[side], stdout=logf, stderr=subprocess.STDOUT,
            )
            logf.close()
            spawned[name] = time.perf_counter()

        # meanwhile the batched client shards its reports on the card
        meas = random_measurements(inst, batch, np.random.default_rng(SEED + 18))
        now = int(time.time())
        reports = make_wire_reports(
            inst, meas[n_client:], task.task_id, task.hpke_keys[0].config, helper_task.hpke_keys[0].config,
            Time(now - 60).to_batch_interval_start(task.time_precision), seed=SEED + 18, shard_chunk=256, device=dev,
        )
        field = circuit_for(inst).FIELD
        size = field.ENCODED_SIZE

        def bump(payload):  # the first measurement element plus 1, inside the field
            v = (int.from_bytes(payload[:size], "little") + 1) % field.MODULUS
            payload[:size] = v.to_bytes(size, "little")

        for i in bad_rows:
            reports[i] = _reseal(task, task.hpke_keys[0].config, reports[i], reports[i].metadata, bump)

        def log_tail(name, n=3000):
            return (tmp / f"{name}.log").read_text(errors="replace")[-n:]

        for side, p in provision.items():
            out, err = p.communicate(timeout=300)
            if p.returncode != 0 or json.loads(out) != [{"task_id": task_id_label(task.task_id.data)}]:
                raise AssertionError(f"binaries: janus_cli provision-tasks ({side}) exited {p.returncode}: "
                                     f"{out[-1000:]} {err[-2000:]}")
        provision_s = time.perf_counter() - t0
        ready_s = {}
        deadline = time.monotonic() + 180
        while len(ready_s) < len(procs):
            for name, p in procs.items():
                if name in ready_s:
                    continue
                if p.poll() is not None:
                    raise AssertionError(f"binaries: {name} exited {p.returncode} at boot: {log_tail(name)}")
                try:
                    if _http(f"http://127.0.0.1:{health[name]}/readyz", timeout=2)[0] == 200:
                        ready_s[name] = time.perf_counter() - spawned[name]
                except OSError:
                    pass
            if time.monotonic() > deadline:
                raise AssertionError(f"binaries: not ready after 180 s: {sorted(set(procs) - set(ready_s))}")
            time.sleep(0.1)
        boot = {name: json.loads(_http(f"http://127.0.0.1:{health[name]}/debug/boot")[1]) for name in procs}

        # 3. the uploads but one: 8 through the Client (8 threads), the
        # rest of the wire reports PUT by 8 threads; the creator packs no
        # job before the batch is whole
        http = HttpClient(timeout=600)
        params = ClientParameters(task.task_id, url["leader"], url["helper"], task.time_precision)
        client = Client.with_fetched_configs(params, inst, http)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(lambda m: client.upload([int(x) for x in m]), meas[:n_client]))
        client_upload_s = time.perf_counter() - t0
        sheds = []

        def put(report):
            def attempt():
                status, body = http.put(params.upload_uri(), report.to_bytes(), {"Content-Type": Report.MEDIA_TYPE})
                if status == 429:
                    sheds.append(1)
                return status, body, http.last_response_headers

            return retry_http_request(attempt, Backoff())[0]

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=8) as pool:
            statuses = list(pool.map(put, reports[:-1]))
        upload_s = time.perf_counter() - t0
        if set(statuses) != {201}:
            raise AssertionError(f"binaries: upload statuses {sorted(set(statuses))}")

        # 4. the profile windows of the job driver and the helper, then the
        # last report: the job is created, stepped and collected inside them
        windows = {}
        window_pool = ThreadPoolExecutor(max_workers=2)
        for name in ("agg_driver", "helper"):
            windows[name] = window_pool.submit(
                _http, f"http://127.0.0.1:{health[name]}/debug/profile?seconds={profile_s}", "POST",
                profile_s + 120.0)
        time.sleep(1.5)  # the profilers start
        window_t0 = time.perf_counter()
        timeline = {}
        if put(reports[-1]) != 201:
            raise AssertionError("binaries: the last upload was refused")
        timeline["uploaded_s"] = time.perf_counter() - window_t0

        # 5. the job: the creator packs it, the driver steps it; the
        # leader's job_health section says when it finished
        t_uploaded = time.perf_counter()
        deadline = time.monotonic() + 120
        while True:
            jobs = json.loads(_http(f"http://127.0.0.1:{health['leader']}/statusz")[1]).get("job_health", {})
            if jobs.get("jobs", {}).get("aggregation/finished", 0) >= 1:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"binaries: no finished aggregation job: {jobs} {log_tail('agg_driver')}")
            time.sleep(0.25)
        job_done_s = time.perf_counter() - t_uploaded
        timeline["job_finished_s"] = time.perf_counter() - window_t0

        # 6. the collection, by the collector's current-batch query
        collector = Collector(CollectorParameters(task.task_id, url["leader"], task.collector_auth_token,
                                                  collector_kp), inst, http)
        t0 = time.perf_counter()
        query = Query.fixed_size(FixedSizeQuery(FixedSizeQuery.CURRENT_BATCH))
        job_id = collector.start_collection(query)
        deadline = time.monotonic() + 120
        while True:
            try:
                result = collector.poll_once(job_id, query)
                break
            except CollectionJobNotReady:
                if time.monotonic() > deadline:
                    raise AssertionError(f"binaries: collection not ready: {log_tail('col_driver')}")
                time.sleep(0.2)
        collect_s = time.perf_counter() - t0
        accept = np.ones(batch, dtype=bool)
        accept[[n_client + i for i in bad_rows]] = False
        truth = [int(x) for x in np.asarray(meas)[accept].sum(axis=0).reshape(-1)]
        finished = batch - len(bad_rows)
        if result.report_count != finished or [int(x) for x in result.aggregate_result] != truth:
            raise AssertionError(f"binaries: collected {result.report_count} reports; the aggregate "
                                 f"{'equals' if list(result.aggregate_result) == truth else 'differs from'} the truth")
        window_wait_t0 = time.perf_counter()
        timeline["collected_s"] = window_wait_t0 - window_t0

        # 7. the profiles: the kernels each process launched on the card
        profiles = {}
        for name, fut in windows.items():
            status, body = fut.result(timeout=profile_s + 180.0)
            if status != 200:
                raise AssertionError(f"binaries: POST /debug/profile on {name} answered {status}: {body[:300]!r}")
            doc = json.loads(body)
            profile_dirs.append(str(Path(doc["device_trace_dir"]).parent))
            t0 = time.perf_counter()
            counts = trace_kernel_counts(doc["device_trace"])
            profiles[name] = {"activities": doc["activities"], "stop_s": doc["stop_s"], "export_s": doc["export_s"],
                              "trace_bytes": os.path.getsize(doc["device_trace"]),
                              "read_s": time.perf_counter() - t0, **counts}
            if on_card and (doc["activities"] != ["cuda"] or not counts["rows"]["keccak_single_block"]
                            or not counts["rows"]["expand_f128"] or counts["rows"]["keccak_sponge"]):
                raise AssertionError(f"binaries: {name}'s CUDA profile shows {counts}; since the windows opened "
                                     f"{timeline} (window {profile_s} s)")
        window_pool.shutdown()
        window_wait_s = time.perf_counter() - window_wait_t0

        # 8. every listener: metrics (both formats, 0 errors), build info,
        # statusz sections, alertz, the flight recorder, the books
        label = task_id_label(task.task_id.data)
        scrapes = {}
        for name in procs:
            base = f"http://127.0.0.1:{health[name]}"
            status, text = _http(base + "/metrics")
            families, errors = exposition.parse_exposition(text.decode())
            om_errors = exposition.validate_exposition(_http(base + "/metrics?openmetrics=1")[1].decode(),
                                                       openmetrics=True)
            build = [lbl for _, lbl, v in families["janus_build_info"].samples if v == 1]
            statusz = json.loads(_http(base + "/statusz")[1])
            alertz = json.loads(_http(base + "/alertz")[1])
            flight = json.loads(_http(base + "/debug/flight")[1])
            want = {"process", "tasks", "slo", "flight", "fleet", "failpoints", "datastore", "device_cost",
                    "engine_cache"} | ({"job_health", "ledger"} if name != "creator" else set())
            if (status != 200 or errors or om_errors or len(build) != 1 or build[0]["backend"] != device_name
                    or not want <= set(statusz) or not alertz.get("enabled") or not flight.get("running")):
                raise AssertionError(f"binaries: {name}'s listener: {errors[:3]} {om_errors[:3]} {build} "
                                     f"{sorted(want - set(statusz))} alertz={alertz.get('enabled')} "
                                     f"flight={flight.get('running')}")
            scrapes[name] = {"families": len(families), "exposition_errors": len(errors),
                             "openmetrics_errors": len(om_errors), "backend": build[0]["backend"],
                             "statusz_sections": len(statusz) - 1, "alerts_firing": alertz["firing"],
                             "flight_snapshots": flight["snapshots_total"],
                             "device_memory": statusz["process"].get("device_memory")}
            if name == "agg_driver":
                stages = {}
                fam = families.get("janus_step_pipeline_stage_seconds")
                for sample, lbl, v in (fam.samples if fam else []):
                    if sample.endswith("_sum"):
                        stages[lbl["stage"]] = v
                scrapes[name]["step_stage_s"] = stages
                scrapes[name]["device_cost"] = statusz["device_cost"]
            if name == "helper":
                scrapes[name]["device_cost"] = statusz["device_cost"]

        def books(name, want_peer):
            deadline = time.monotonic() + 30
            while True:
                doc = json.loads(_http(f"http://127.0.0.1:{health[name]}/debug/ledger")[1])
                t = doc.get("tasks", {}).get(label)
                ok = t is not None and (t["admitted"], t["aggregated"], t["collected"], t["lost"]) == (
                    batch, finished, finished, 0) and t["rejected"] == {"vdaf_prep_error": len(bad_rows)} \
                    and not any(t["imbalance"].values()) and not doc.get("breaches")
                peer = t.get("peer") if t else None
                if ok and (not want_peer or (peer and peer["divergence"] == 0 and peer["batches_compared"] >= 1)):
                    return {k: t[k] for k in ("admitted", "aggregated", "collected", "rejected", "imbalance")} | (
                        {"peer_divergence": peer["divergence"]} if want_peer else {})
                if time.monotonic() > deadline:
                    raise AssertionError(f"binaries: {name}'s books {t} breaches {doc.get('breaches')}")
                time.sleep(0.5)

        ledger_books = {"leader": books("col_driver", True), "helper": books("helper", False)}

        # 9. SIGTERM: every process exits 0 and logs its shutdown
        drain_s, rcs = {}, {}
        t0 = time.perf_counter()
        for p in procs.values():
            p.send_signal(signal.SIGTERM)
        for name, p in procs.items():
            try:
                rcs[name] = p.wait(timeout=max(1.0, 30.0 - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"binaries: {name} still running 30 s after SIGTERM: {log_tail(name)}")
            drain_s[name] = time.perf_counter() - t0
            if rcs[name] != 0 or "shut down" not in log_tail(name, 20000):
                raise AssertionError(f"binaries: {name} exited {rcs[name]}: {log_tail(name)}")
        return {
            "path": "binaries-sumvec",
            "vdaf": inst.to_dict(),
            "device": device,
            "batch": batch,
            "provision_s": provision_s,
            "ready_s": ready_s,
            "boot_s": {n: b.get("total_s") for n, b in boot.items()},
            "boot_phases_s": {n: {p["phase"]: p["seconds"] for p in b["phases"]} for n, b in boot.items()},
            "client_upload_s": client_upload_s,
            "upload_s": upload_s,
            "uploads_per_s": (n_wire - 1) / upload_s,
            "sheds_429": len(sheds),
            "uploaded_to_job_finished_s": job_done_s,
            "collect_s": collect_s,
            "report_count": result.report_count,
            "aggregate_ok": True,
            "profile_s": profile_s,
            "since_windows_opened_s": timeline,
            "profile_wait_s": window_wait_s,
            "profiles": profiles,
            "scrapes": scrapes,
            "ledger": ledger_books,
            "exit_codes": rcs,
            "drain_s": drain_s,
            "phase_s": time.perf_counter() - phase_t0,
        }
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for d in profile_dirs:
            shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)


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
    # the step's device kernels by the profiler: kernel 1 once a
    # permutation batch, nothing else per lane
    t0 = time.perf_counter()
    profile = profile_step(torch, lambda: both_parties([]), (), step_s)
    profile["profile_s"] = time.perf_counter() - t0
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
        "profile": profile,
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


def check_merged_round(torch, dev, inst, keys, n: int, seed: int):
    """The per-lane verify keys through kernels 1 and 2 (see the module
    docstring, phase 15): two tasks' n-report batches (one engine a key)
    as two solo rounds and as one merged round, leader then helper, by
    the engine's round functions; every out share, seed, verifier share,
    joint-rand part, mask and prep message must be equal bit for bit.
    Returns the record, with kernels 1 and 2's launches a solo round and
    a merged round (counts at 0 just before each, read just after)."""
    import numpy as np

    from janus_tpu_torch.aggregator import engine_cache as ec
    from janus_tpu_torch.convert import step_args_to_numpy
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    counters = kernel_counters()
    engines = [ec.engine_cache(inst, key, dev) for key in keys]
    batches = []
    for j in range(len(keys)):
        meas = random_measurements(inst, n, np.random.default_rng(seed + j))
        args, _ = make_report_batch(inst, meas, seed=seed + j, shard_chunk=256, device=dev)
        batches.append(step_args_to_numpy(args))
    ok = np.ones(n, dtype=bool)

    def counted(fn):
        _sync(torch, dev)
        for c in counters.values():
            c.launches = 0
        out = fn()
        _sync(torch, dev)
        return out, {k: c.launches for k, c in counters.items()}

    def leader_entries(idx):
        return [(engines[j], None, *batches[j][:5]) for j in idx]

    def helper_entries(idx, lead):
        return [(engines[j], batches[j][0], batches[j][1], batches[j][5], batches[j][6], lead[k][2], lead[k][3], ok)
                for k, j in enumerate(idx)]

    solo_lead, solo_help, launches = [], [], {}
    for j in range(len(keys)):
        (lead,), launches["leader_solo"] = counted(lambda: ec._run_leader_round(leader_entries([j]), [n]))
        (helped,), launches["helper_solo"] = counted(lambda: ec._run_helper_round(helper_entries([j], [lead]), [n]))
        solo_lead.append(lead)
        solo_help.append(helped)
    idx = list(range(len(keys)))
    merged_lead, launches["leader_merged"] = counted(lambda: ec._run_leader_round(leader_entries(idx), [n] * len(idx)))
    merged_help, launches["helper_merged"] = counted(
        lambda: ec._run_helper_round(helper_entries(idx, merged_lead), [n] * len(idx)))

    def err(a, b) -> int:
        if a is None or b is None:
            if a is not b:
                raise AssertionError("merged round: a value is None on one side only")
            return 0
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        worst = 0
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            if x.shape != y.shape:
                raise AssertionError(f"merged round: shapes {x.shape} and {y.shape}")
            if not np.array_equal(x, y):
                d = np.flatnonzero(x.reshape(-1) != y.reshape(-1))
                worst = max(worst, max(abs(int(x.reshape(-1)[i]) - int(y.reshape(-1)[i])) for i in d))
        return worst

    errs = {}
    for j in idx:
        (o0, s0, v0, p0), (mo0, ms0, mv0, mp0) = solo_lead[j], merged_lead[j]
        (o1, m1, q1), (mo1, mm1, mq1) = solo_help[j], merged_help[j]
        if not isinstance(mo0, ec.DeviceRows) or mo0.offset != j * n:
            raise AssertionError("merged round: the leader's out shares are not views into one buffer")
        for what, a, b in (("out0", o0.to_numpy(), mo0.to_numpy()), ("seed0", s0, ms0), ("ver0", v0, mv0),
                           ("part0", p0, mp0), ("out1", o1.to_numpy(), mo1.to_numpy()), ("mask", m1, mm1),
                           ("prep", q1, mq1)):
            errs[what] = max(errs.get(what, 0), err(a, b))
        if not np.asarray(m1).all():
            raise AssertionError(f"merged round: task {j}'s honest reports did not verify")
    max_err = max(errs.values())
    if max_err != 0:
        raise AssertionError(f"merged round: merged != solo ({errs})")
    if _on_card(torch, dev):
        for side in ("leader", "helper"):
            solo, merged = launches[f"{side}_solo"], launches[f"{side}_merged"]
            if merged != solo or not (solo["keccak_single_block"] and solo["expand_f128"]):
                raise AssertionError(f"merged round: {side} launches solo {solo}, merged {merged}")
    return {"tasks": len(keys), "rows_a_task": n, "max_abs_err": max_err, "max_abs_err_by_value": errs,
            "launches": launches, "merged_rounds": engines[0].coalesce_stats["merged_rounds"]}


class _MergeSeconds:
    """While open, times every EngineCache.resident_merge to its device
    work's end (a synchronize after it) and keeps the seconds."""

    def __init__(self, torch, dev):
        import threading

        from janus_tpu_torch.aggregator.engine_cache import EngineCache

        self.torch, self.dev, self.cls = torch, dev, EngineCache
        self.seconds: list = []
        self._lock = threading.Lock()

    def __enter__(self):
        self._raw = self.cls.__dict__["resident_merge"]
        raw, torch, dev = self._raw, self.torch, self.dev

        def timed(eng, *a, **kw):
            t0 = time.perf_counter()
            try:
                return raw(eng, *a, **kw)
            finally:
                _sync(torch, dev)
                with self._lock:
                    self.seconds.append(time.perf_counter() - t0)

        self.cls.resident_merge = timed
        return self.seconds

    def __exit__(self, *exc):
        self.cls.resident_merge = self._raw


class _HoldFirstRound:
    """While open, the coalescer's first round waits (at most timeout_s)
    until `behind` more calls have queued behind it, as they do on a
    leader whose jobs arrive together; behind 0 holds nothing. The wait
    is kept in wait_s."""

    def __init__(self, co, behind: int, timeout_s: float = 30.0):
        self.co, self.behind, self.timeout_s = co, behind, timeout_s
        self.wait_s = 0.0

    def __enter__(self):
        co, raw = self.co, self.co._run
        self._raw, held = raw, []

        def run(args_list, ns):
            if self.behind and not held:
                held.append(True)
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < self.timeout_s:
                    with co._lock:
                        if len(co._queue) >= self.behind:
                            break
                    time.sleep(0.005)
                self.wait_s = time.perf_counter() - t0
            return raw(args_list, ns)

        co._run = run
        return self

    def __exit__(self, *exc):
        self.co._run = self._raw


def phase_pipeline_resident(torch, dev, inst, keys, per_task: int, job_size: int, bad_rows, runs,
                            merged_check_rows: int = 0):
    """The stage pipeline with prestaged leader columns, resident
    accumulators and cross-task coalescing (see the module docstring,
    phases 15 and 16): a port leader and a port helper over loopback
    HTTP, one task per verify key in `keys`, per_task reports a task at
    one client time, in jobs of job_size. `runs`: (device_lane_workers,
    jobs) of each JobDriver pass, through a StepPipeline with that many
    lane and read workers, or through the serial stepper where
    device_lane_workers is 0; with more than two lane workers and jobs,
    the pass's first leader round waits until the others queued behind it
    (_HoldFirstRound) and a merged round must run. bad_rows: (task, row) pairs
    whose leader share is bumped (dense circuits). The resident slots are
    flushed once at the end with flush_resident_state("drain"), and each
    task is collected and held against the truth. Returns the record."""
    import dataclasses

    import numpy as np

    from janus_tpu_torch.aggregator import engine_cache as ec
    from janus_tpu_torch.aggregator.aggregation_job_creator import AggregationJobCreator, AggregationJobCreatorConfig
    from janus_tpu_torch.aggregator.aggregation_job_driver import (
        AggregationJobDriver,
        AggregationJobDriverConfig,
        ResidentConfig,
    )
    from janus_tpu_torch.aggregator.core import Aggregator
    from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.aggregator.step_pipeline import StepPipeline, StepPipelineConfig
    from janus_tpu_torch.aggregator.testing import leader_stored_reports
    from janus_tpu_torch.convert import step_args_to_numpy
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.messages import Interval, PrepareError, Query, Role, Time, decode_reports_fast
    from janus_tpu_torch.task import QueryTypeConfig, Task, TaskBuilder
    from janus_tpu_torch.vdaf.feasibility import prepare_row_bytes, resident_route_bytes, sparse_aggregate_bytes
    from janus_tpu_torch.vdaf.registry import circuit_for
    from janus_tpu_torch.vdaf.testing import make_report_batch, make_wire_reports, random_measurements
    from janus_tpu_torch.vdaf.wire import flat_scatter_indices

    now = 1_700_000_000
    sparse = inst.kind == "sparse_sumvec"
    circ = circuit_for(inst)
    field = circ.FIELD
    counters = kernel_counters()
    rec = {"vdaf": inst.to_dict(), "tasks": len(keys), "reports": per_task * len(keys), "job_size": job_size}
    if merged_check_rows:
        rec["merged_round"] = check_merged_round(torch, dev, inst, keys, merged_check_rows, SEED + 40)

    leader_eds = EphemeralDatastore(MockClock(Time(now)))
    helper_eds = EphemeralDatastore(MockClock(Time(now)))
    helper = Aggregator(helper_eds.datastore, helper_eds.clock, device=dev)
    leader = Aggregator(leader_eds.datastore, leader_eds.clock, device=dev)
    server = DapServer(DapHttpApp(helper)).start()
    leader_server = DapServer(DapHttpApp(leader)).start()
    try:
        collector_kp = generate_hpke_config_and_private_key(config_id=7)
        tasks, truths, accepts, bad_ids = [], [], [], []
        t0 = time.perf_counter()
        for t, key in enumerate(keys):
            built = TaskBuilder(QueryTypeConfig.time_interval(), inst, Role.LEADER).with_(
                vdaf_verify_key=key, aggregator_auth_token=AuthenticationToken.random_bearer(),
                collector_hpke_config=collector_kp.config, helper_aggregator_endpoint=server.url,
            ).build()
            task = Task.from_dict(built.to_dict())
            helper_task = Task.from_dict(dataclasses.replace(
                built, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
            ).to_dict())
            helper_eds.datastore.run_tx(lambda tx: tx.put_task(helper_task))
            leader_eds.datastore.run_tx(lambda tx: tx.put_task(task))
            bad = sorted(r for tt, r in bad_rows if tt == t)
            accept = np.ones(per_task, dtype=bool)
            accept[bad] = False
            if sparse:
                meas, block_idx, compact = sparse_measurements(inst, per_task, SEED + 50 + t)
                wire = make_wire_reports(inst, meas, task.task_id, task.hpke_keys[0].config,
                                         helper_task.hpke_keys[0].config, Time(now - 100), seed=SEED + 50 + t,
                                         shard_chunk=256, device=dev)
                ta = leader.task_aggregator_for(task.task_id)
                col = decode_reports_fast([r.to_bytes() for r in wire])
                (kp,) = {id(k): k for k in ta.upload_prepare_columns(leader_eds.clock, col, range(per_task))}.values()
                reports = ta.upload_decrypt_validate_batch(col, list(range(per_task)), kp)
                flat = flat_scatter_indices(block_idx, circ)
                truths.append(sparse_truth(circ.agg_output_len, flat, compact, np.flatnonzero(accept)))
                ids = [r.metadata.report_id.data for r in wire]
            else:
                meas = random_measurements(inst, per_task, np.random.default_rng(SEED + 50 + t))
                args, _ = make_report_batch(inst, meas, seed=SEED + 50 + t, shard_chunk=256, device=dev)
                args = list(step_args_to_numpy(args))
                args[2] = _bump_host_rows(args[2], bad, field.MODULUS)
                reports = leader_stored_reports(task, helper_task.hpke_keys[0].config, args, [now - 100] * per_task)
                truths.append([int(x) for x in np.asarray(meas)[accept].sum(axis=0).reshape(-1)])
                ids = [r.report_id.data for r in reports]
            leader_eds.datastore.run_tx(lambda tx: [tx.put_client_report(r) for r in reports])
            tasks.append(task)
            accepts.append(accept)
            bad_ids.append({ids[i] for i in bad})
        rec["upload_s"] = time.perf_counter() - t0
        created = AggregationJobCreator(leader_eds.datastore, AggregationJobCreatorConfig(
            min_aggregation_job_size=1, max_aggregation_job_size=job_size)).run_once()
        n_jobs = len(keys) * -(-per_task // job_size)
        if created != n_jobs or sum(j for _, j in runs) != n_jobs:
            raise AssertionError(f"pipeline: the creator made {created} jobs, not {n_jobs}")

        driver = AggregationJobDriver(
            leader_eds.datastore, HttpClient(timeout=600),
            AggregationJobDriverConfig(resident=ResidentConfig(enabled=True, flush_interval_s=3600.0)),
            breakers=OutboundCircuitBreakers(), device=dev,
        )
        engines = [leader.task_aggregator_for(t.task_id).engine for t in tasks]
        helper_engine = helper.task_aggregator_for(tasks[0].task_id).engine
        # the model: a job's rows in flight on the lane and in the helper's
        # requests (http_inflight of them), and what the resident route
        # keeps: each job's pending delta and the slots
        # (a serial pass: each of its jobs' inits and helper requests at once)
        rows_in_flight = job_size * max(w + StepPipelineConfig().http_inflight if w else 2 * j for w, j in runs)
        step_model = rows_in_flight * prepare_row_bytes(circ)
        if sparse:
            step_model = max(step_model, sparse_aggregate_bytes(circ, rows_in_flight))
        run_recs = []
        for workers, jobs in runs:
            job_s = []
            if workers:
                pipe = StepPipeline(driver, StepPipelineConfig(device_lane_workers=workers,
                                                               prefetch_depth=max(2, workers), double_buffer=True))
                stepper = driver.stepper
            else:  # the serial stepper on the same driver: a job's seconds are its step's
                pipe = None

                def stepper(acquired, job_s=job_s):
                    t = time.perf_counter()
                    try:
                        driver.stepper(acquired)
                    finally:
                        job_s.append(time.perf_counter() - t)
            job_driver = JobDriver(JobDriverConfig(max_concurrent_job_workers=jobs), driver.acquirer(), stepper,
                                   pipeline=pipe)
            hold = _HoldFirstRound(engines[0]._co_leader, jobs - 1 if workers > 2 and jobs > 2 else 0)
            before = [dict(e.prestage_stats) for e in engines]
            merges_before = sum(e.resident_status()["merges"] for e in engines)
            engines[0]._co_leader.rounds.clear()
            helper_engine._co_helper.rounds.clear()
            # the run: counts at 0 just before, read just after
            device_before = _peak_reset(torch, dev)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            try:
                with _MergeSeconds(torch, dev) as merge_s, hold:
                    stepped = job_driver.run_once()
                _sync(torch, dev)
                run_s = time.perf_counter() - t0
                launches = {k: fn.launches for k, fn in counters.items()}
                peak = _peak(torch, dev)
                if pipe is not None:
                    status = pipe.status()
                    stage_samples = {k: list(v) for k, v in pipe.stage_seconds.items()}
                    job_s = list(pipe.job_seconds)
                else:
                    status = {"jobs_done": stepped, "classic_fallbacks": driver.classic_fallbacks,
                              "prestage": {"declined": 0}, "device_lane": None, "overlap_events": None}
                    stage_samples = {}
            finally:
                if pipe is not None:
                    pipe.close()
            if stepped != jobs or status["jobs_done"] != jobs:
                raise AssertionError(f"pipeline: {stepped} jobs stepped, {status['jobs_done']} done, not {jobs}")
            leader_rounds = list(engines[0]._co_leader.rounds)
            helper_rounds = list(helper_engine._co_helper.rounds)
            prestage = {k: sum(e.prestage_stats[k] - b[k] for e, b in zip(engines, before)) for k in before[0]}
            merges = sum(e.resident_status()["merges"] for e in engines) - merges_before
            if merges != jobs or status["classic_fallbacks"] != 0:
                raise AssertionError(f"pipeline: {merges} merges for {jobs} jobs, {status['classic_fallbacks']} "
                                     "classic fallbacks")
            if workers == 1 and (prestage["issued"] != jobs or prestage["used"] != jobs):
                raise AssertionError(f"pipeline: a single lane's prestages {prestage}, not every job's used")
            if workers > 1 and status["prestage"]["declined"] != jobs:
                raise AssertionError(f"pipeline: a parallel lane declined {status['prestage']} of {jobs} prestages")
            if hold.behind and max(leader_rounds) < 2:
                raise AssertionError(f"pipeline: {workers} lanes merged no leader round: {leader_rounds}")
            if _on_card(torch, dev):
                mr = rec.get("merged_round")
                if mr is not None:
                    # per round, not per job: a merged round launches what a solo one does
                    for k in ("keccak_single_block", "expand_f128"):
                        want = (len(leader_rounds) * mr["launches"]["leader_solo"][k]
                                + len(helper_rounds) * mr["launches"]["helper_solo"][k])
                        if launches[k] != want:
                            raise AssertionError(f"pipeline: {k} launched {launches[k]} times, not {want} for "
                                                 f"{len(leader_rounds)} leader and {len(helper_rounds)} helper rounds")
                want_kernels = ("keccak_single_block", "expand_f128") + (("scatter_rows",) if sparse else ())
                _check_launches(torch, dev, "pipeline run", launches, want_kernels)
                if sparse and launches["scatter_rows"] != 2 * jobs:
                    # a merge a job on the leader, an aggregate_sparse a request on the helper
                    raise AssertionError(f"pipeline: kernel 4 launched {launches['scatter_rows']} times for {jobs} "
                                         "resident merges and helper aggregates")
            resident = ec.resident_bytes_total()
            route = resident_route_bytes(circ, 1, resident)
            model = step_model + jobs * route["pending_delta"] + resident
            if _on_card(torch, dev) and peak - device_before > model:
                raise AssertionError(f"pipeline: the run's peak {peak - device_before} bytes past model + resident "
                                     f"{model}")
            run_recs.append({
                "device_lane_workers": workers,
                "stepper": "pipeline" if workers else "serial",
                "jobs": jobs,
                "run_s": run_s,
                "first_round_wait_s": hold.wait_s,
                "job_s": {"p50": _percentile(job_s, 0.5), "p95": _percentile(job_s, 0.95), "all": job_s},
                "stage_s": {k: {"p50": _percentile(v, 0.5), "p95": _percentile(v, 0.95), "n": len(v)}
                            for k, v in sorted(stage_samples.items())},
                "round_sizes": {"leader": leader_rounds, "helper": helper_rounds},
                "prestage": {**prestage, "declined": status["prestage"]["declined"]},
                "merges": merges,
                "merge_s": merge_s,
                "classic_fallbacks": status["classic_fallbacks"],
                "device_lane": status["device_lane"],
                "overlap_events": status["overlap_events"],
                "launches": launches,
                "peak_device_bytes": peak - device_before,
                "model_peak_bytes": step_model + jobs * route["pending_delta"],
                "resident_bytes": resident,
            })
        rec["runs"] = run_recs
        rec["launches"] = {k: sum(r["launches"][k] for r in run_recs) for k in counters}
        rec["resident_status"] = [e.resident_status() for e in engines]
        if job_driver.run_once() != 0:
            raise AssertionError("pipeline: a pass after the runs acquired a job")

        # every job finished with its lease released, exactly the bumped
        # reports failed
        for t, task in enumerate(tasks):
            rows = leader_eds.datastore.run_tx(lambda tx: tx._c.execute(
                "SELECT state, lease_token IS NULL, lease_attempts FROM aggregation_jobs WHERE task_id = ?",
                (task.task_id.data,)).fetchall())
            if sorted(set(rows)) != [("finished", 1, 0)]:
                raise AssertionError(f"pipeline: task {t}'s job rows {sorted(set(rows))}")
            jobs = leader_eds.datastore.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(task.task_id))
            ras = [ra for j in jobs for ra in leader_eds.datastore.run_tx(
                lambda tx: tx.get_report_aggregations_for_job(task.task_id, j.job_id))]
            failed = {ra.report_id.data: ra.prepare_error for ra in ras if ra.state.value == "failed"}
            if set(failed) != bad_ids[t] or set(failed.values()) - {PrepareError.VDAF_PREP_ERROR}:
                raise AssertionError(f"pipeline: task {t} failed {len(failed)} reports, not its bumped ones")
        merged_rows = sum(s["merged_rows"] for s in rec["resident_status"])
        if merged_rows != sum(int(a.sum()) for a in accepts):
            raise AssertionError(f"pipeline: {merged_rows} rows merged resident")

        t0 = time.perf_counter()
        flushed = driver.flush_resident_state("drain")
        rec["flush_s"] = time.perf_counter() - t0
        if flushed != len(keys) or ec.resident_bytes_total() != 0 or driver.resident_lost:
            raise AssertionError(f"pipeline: the drain flushed {flushed} slots, {ec.resident_bytes_total()} bytes "
                                 f"left, {driver.resident_lost} lost")
        rec["flushed_slots"] = flushed
        rec["collect"] = []
        for task, accept, truth in zip(tasks, accepts, truths):
            window = Time(now - 100).to_batch_interval_start(task.time_precision)
            c = collect_batch(torch, counters, task, leader_server.url, leader_eds, collector_kp,
                              Query.time_interval(Interval(window, task.time_precision)), int(accept.sum()), truth,
                              dev=dev)
            rec["collect"].append({"report_count": c["report_count"], "collect_s": c["collect_s"],
                                   "result_ok": c["result_ok"]})
        return rec
    finally:
        leader_server.stop()
        server.stop()
        leader.close()
        leader_eds.cleanup()
        helper_eds.cleanup()


class DrillPair:
    """The fault drills' pair (phases 17, 18 and 20): a port leader and a
    port helper over loopback DapServers (the leader behind its own as
    well, for the collector), one time-interval task per entry of
    `task_ids` (None: a random id) whose helper endpoint is
    `endpoint(helper_url)` (a FaultProxy's URL in the peer-outage drill),
    and `n` reports of `inst` a task made on `dev` and stored at the
    leader, the leader shares of `bad_rows` bumped inside the field. With
    `create`, the creator packs them into jobs of `job_size` reports. The
    tasks share one verify key, so the leader and the helper share one
    engine; `task`, `helper_task`, `meas` and `reports` are the first
    task's."""

    NOW = 1_700_000_000

    def __init__(self, torch, dev, inst, n: int, job_size: int, seed: int, endpoint=lambda url: url,
                 task_ids=(None,), bad_rows=(), create: bool = True):
        import dataclasses

        import numpy as np

        from janus_tpu_torch.aggregator.aggregation_job_creator import (
            AggregationJobCreator,
            AggregationJobCreatorConfig,
        )
        from janus_tpu_torch.aggregator.core import Aggregator
        from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
        from janus_tpu_torch.aggregator.testing import leader_stored_reports
        from janus_tpu_torch.convert import step_args_to_numpy
        from janus_tpu_torch.core.auth import AuthenticationToken
        from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
        from janus_tpu_torch.core.time_util import MockClock
        from janus_tpu_torch.datastore import EphemeralDatastore
        from janus_tpu_torch.messages import Role, TaskId, Time
        from janus_tpu_torch.task import QueryTypeConfig, Task, TaskBuilder
        from janus_tpu_torch.vdaf.registry import circuit_for
        from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

        self.torch, self.dev, self.inst = torch, dev, inst
        self.collector_kp = generate_hpke_config_and_private_key(config_id=7)
        self.leader_eds = EphemeralDatastore(MockClock(Time(self.NOW)))
        self.helper_eds = EphemeralDatastore(MockClock(Time(self.NOW)))
        self.helper = Aggregator(self.helper_eds.datastore, self.helper_eds.clock, device=dev)
        self.leader = Aggregator(self.leader_eds.datastore, self.leader_eds.clock, device=dev)
        self.server = DapServer(DapHttpApp(self.helper)).start()
        self.leader_server = DapServer(DapHttpApp(self.leader)).start()
        # per task: (leader task, helper task, measurements, stored reports,
        # accepted rows)
        self.tasks = []
        try:
            for i, task_id in enumerate(task_ids):
                built = TaskBuilder(QueryTypeConfig.time_interval(), inst, Role.LEADER).with_(
                    vdaf_verify_key=VERIFY_KEY, aggregator_auth_token=AuthenticationToken.random_bearer(),
                    collector_hpke_config=self.collector_kp.config,
                    **({} if task_id is None else {"task_id": TaskId(task_id)}),
                ).build()
                helper_task = Task.from_dict(dataclasses.replace(
                    built, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
                ).to_dict())
                task = Task.from_dict(dataclasses.replace(
                    built, helper_aggregator_endpoint=endpoint(self.server.url)).to_dict())
                self.helper_eds.datastore.run_tx(lambda tx: tx.put_task(helper_task))
                self.leader_eds.datastore.run_tx(lambda tx: tx.put_task(task))
                meas = random_measurements(inst, n, np.random.default_rng(seed + i))
                args, _ = make_report_batch(inst, meas, seed=seed + i, device=dev)
                args = list(step_args_to_numpy(args))
                if bad_rows:
                    args[2] = _bump_host_rows(args[2], sorted(bad_rows), circuit_for(inst).FIELD.MODULUS)
                reports = leader_stored_reports(task, helper_task.hpke_keys[0].config, args, [self.NOW - 100] * n)
                self.leader_eds.datastore.run_tx(lambda tx: [tx.put_client_report(r) for r in reports])
                accept = np.ones(n, dtype=bool)
                accept[list(bad_rows)] = False
                self.tasks.append((task, helper_task, meas, reports, accept))
            self.task, self.helper_task, self.meas, self.reports, _ = self.tasks[0]
            self.engine = self.leader.task_aggregator_for(self.task.task_id).engine
            if any(self.helper.task_aggregator_for(h.task_id).engine is not self.engine for _, h, *_ in self.tasks):
                raise AssertionError("drill: the leader and the helper do not share one engine")
            self.n_jobs = 0
            if create:
                cfg = AggregationJobCreatorConfig(min_aggregation_job_size=job_size,
                                                  max_aggregation_job_size=job_size)
                self.n_jobs = AggregationJobCreator(self.leader_eds.datastore, cfg).run_once()
                if self.n_jobs != len(self.tasks) * (n // job_size):
                    raise AssertionError(f"drill: the creator made {self.n_jobs} jobs of {n} reports a task")
        except BaseException:
            self.close()
            raise

    def advance(self, secs: int) -> None:
        from janus_tpu_torch.messages import Duration

        self.leader_eds.clock.advance(Duration(secs))
        self.helper_eds.clock.advance(Duration(secs))

    def job_rows(self):
        """(state, lease released, attempts) of every job, in job id order."""
        return self.leader_eds.datastore.run_tx(lambda tx: tx._c.execute(
            "SELECT state, lease_token IS NULL, lease_attempts FROM aggregation_jobs ORDER BY job_id").fetchall())

    def collect(self, counters, i: int = 0) -> dict:
        """Collect task i's one batch: every accepted report, summed, must
        come back."""
        import numpy as np

        from janus_tpu_torch.messages import Interval, Query, Time

        task, _, meas, _, accept = self.tasks[i]
        tp = task.time_precision
        window = Time(self.NOW - 100).to_batch_interval_start(tp)
        total = np.asarray(meas)[accept].sum(axis=0)
        truth = int(total) if np.ndim(total) == 0 else [int(x) for x in total.reshape(-1)]
        return collect_batch(self.torch, counters, task, self.leader_server.url, self.leader_eds,
                             self.collector_kp, Query.time_interval(Interval(window, tp)), int(accept.sum()), truth,
                             dev=self.dev)

    def close(self) -> None:
        self.leader_server.stop()
        self.server.stop()
        self.leader.close()
        self.leader_eds.cleanup()
        self.helper_eds.cleanup()


def _count_step_backs(driver):
    """Record each step-back's (reason, delay, monotonic time) on `driver`."""
    real = driver.step_back
    seen = []

    def step_back(acquired, reason, delay_s):
        seen.append((reason, delay_s, time.monotonic()))
        return real(acquired, reason, delay_s)

    driver.step_back = step_back
    return seen


def _zeroed(counters):
    for fn in counters.values():
        fn.launches = 0
    return counters


def _launches(counters) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


def phase_device_hang_drill(torch, dev, inst, job_size: int = 128, lease_s: int = 4, hang_after_s: float = 1.0):
    """The card as a failable peer (see the module docstring, phase 17):
    three jobs of `job_size` reports on one engine that the leader and the
    helper share. A healthy step (which also warms the engine); a step
    whose dispatch hangs (`engine.dispatch=hang,count=1` under a lease of
    lease_s seconds, the watchdog's hang bound hang_after_s for this step
    only: it must fall inside the lease's budget) steps back
    `device_hang`; a step while quarantined steps back
    `device_quarantined` with no kernel launched, and the helper sheds a
    direct aggregate-init 503; then the drill wakes the canary (whose own
    delay is a minute, so nothing restores the engine before), which
    restores it; both jobs complete and the collection equals the ground
    truth. Then a prestaged leader init through the watchdog's worker, on
    a side stream, must equal the direct init."""
    import base64

    import numpy as np

    from janus_tpu_torch import failpoints
    from janus_tpu_torch.aggregator import device_watchdog
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, AggregationJobDriverConfig
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers
    from janus_tpu_torch.core.deadline import deadline_scope
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.messages import AggregationJobInitializeReq, PartialBatchSelector

    t_phase = time.perf_counter()
    watchdog = device_watchdog.WATCHDOG
    if watchdog.status()["abandoned_threads"] or watchdog.device_down():
        raise AssertionError(f"device-hang-drill: the watchdog is not clean ({watchdog.status()})")
    pair = DrillPair(torch, dev, inst, 3 * job_size, job_size, SEED + 20)
    try:
        engine = pair.engine
        engine.QUARANTINE_CANARY_DELAY_SECS = 60.0  # the drill wakes the canary itself
        cfg = AggregationJobDriverConfig(worker_lease_clock_skew_s=1, min_step_back_delay_s=1)
        driver = AggregationJobDriver(pair.leader_eds.datastore, HttpClient(timeout=600), cfg,
                                      breakers=OutboundCircuitBreakers(), device=dev)
        step_backs = _count_step_backs(driver)
        # the healthy and the completing steps under 600 s leases (a cold
        # engine's first init may outlast a short one), the hung and the
        # refused step under lease_s
        job_driver = JobDriver(JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(), driver.stepper)
        short_driver = JobDriver(JobDriverConfig(max_concurrent_job_workers=1),
                                 driver.acquirer(lease_duration_s=lease_s), driver.stepper)
        counters = kernel_counters()
        rec = {"path": "device-hang-drill", "vdaf": inst.to_dict(), "jobs": pair.n_jobs, "job_size": job_size,
               "lease_s": lease_s, "hang_after_s": hang_after_s}

        # a healthy step
        _sync(torch, dev)
        _zeroed(counters)
        t0 = time.perf_counter()
        if job_driver.run_once() != 1:
            raise AssertionError("device-hang-drill: the healthy step did not run")
        rec["healthy_step_s"] = time.perf_counter() - t0
        rec["launches_healthy"] = _launches(counters)
        _check_launches(torch, dev, "device-hang-drill healthy step", rec["launches_healthy"])
        if [r[0] for r in pair.job_rows()].count("finished") != 1:
            raise AssertionError(f"device-hang-drill: after the healthy step {pair.job_rows()}")

        # the hang: the step's dispatch parks its worker past the hang bound
        failpoints.configure("engine.dispatch=hang,count=1")
        default_bound = watchdog.hang_after_s
        watchdog.hang_after_s = hang_after_s
        t0 = time.perf_counter()
        try:
            if short_driver.run_once() != 1:
                raise AssertionError("device-hang-drill: the hung step did not run")
        finally:
            watchdog.hang_after_s = default_bound
        rec["hung_step_s"] = time.perf_counter() - t0
        wd = watchdog.status()
        if [s[0] for s in step_backs] != ["device_hang"] or wd["abandoned_threads"] != 1 or not engine._quarantined:
            raise AssertionError(f"device-hang-drill: step-backs {step_backs}, watchdog {wd}, "
                                 f"quarantined {engine._quarantined}")
        hang_began = time.monotonic() - wd["stalled"][0]["age_s"]
        rec["hang_to_step_back_s"] = step_backs[0][2] - hang_began
        rec["watchdog"] = wd

        # a step while quarantined: refused before staging, no launch
        _zeroed(counters)
        if short_driver.run_once() != 1:
            raise AssertionError("device-hang-drill: the quarantined step did not run")
        rec["launches_quarantined"] = _launches(counters)
        if [s[0] for s in step_backs] != ["device_hang", "device_quarantined"] or any(
                rec["launches_quarantined"].values()):
            raise AssertionError(f"device-hang-drill: step-backs {step_backs}, launches while quarantined "
                                 f"{rec['launches_quarantined']}")
        rec["step_backs"] = [[r, d] for r, d, _ in step_backs]
        rows = pair.job_rows()
        if sorted(rows) != [("finished", 1, 0), ("in_progress", 1, 0), ("in_progress", 1, 0)]:
            raise AssertionError(f"device-hang-drill: job rows {rows} (leases released, attempts refunded)")
        b64 = lambda b: base64.urlsafe_b64encode(b).decode().rstrip("=")  # noqa: E731
        http = HttpClient(timeout=60)
        status, body = http.put(
            f"{pair.server.url}tasks/{b64(pair.task.task_id.data)}/aggregation_jobs/{b64(bytes(range(16)))}",
            AggregationJobInitializeReq(b"", PartialBatchSelector.time_interval(), ()).to_bytes(),
            {"Content-Type": AggregationJobInitializeReq.MEDIA_TYPE,
             **pair.task.aggregator_auth_token.request_headers()},
        )
        retry_after = {k.lower(): v for k, v in http.last_response_headers.items()}.get("retry-after")
        if status != 503 or retry_after is None or b"device_quarantined" not in body:
            raise AssertionError(f"device-hang-drill: the helper answered {status} {body[:200]!r}")
        rec["helper_shed"] = {"status": status, "retry_after": retry_after}

        # the canary, woken now, restores the engine
        if not engine._quarantined or engine.quarantine_stats["canary_probes"]:
            raise AssertionError(f"device-hang-drill: the canary ran before its wake-up ({engine.engine_status()})")
        woken = time.monotonic()
        engine._canary_wakeup.set()
        while engine._quarantined and time.monotonic() < woken + 30:
            time.sleep(0.01)
        st = engine.engine_status()
        if st["backend"] != "device" or st["quarantine"]["restored"] != 1:
            raise AssertionError(f"device-hang-drill: the canary did not restore the engine ({st})")
        rec["wake_to_restore_s"] = engine._quarantined_at + st["quarantine"]["last_quarantine_s"] - woken
        rec["canary_probe_s"] = st["quarantine"]["last_probe_s"]
        rec["engine"] = st
        # the parked worker raises (no device work) and retires
        failpoints.release_hangs()
        failpoints.clear()
        if not watchdog.drain(10.0):
            raise AssertionError(f"device-hang-drill: the parked worker did not retire ({watchdog.status()})")

        # both jobs complete (past the refused step's delay, the canary's
        # minute); the collection equals the ground truth
        pair.advance(120)
        _sync(torch, dev)
        _zeroed(counters)
        t0 = time.perf_counter()
        stepped = 0
        while job_driver.run_once():
            stepped += 1
        rec["completing_steps_s"] = time.perf_counter() - t0
        rec["launches"] = _launches(counters)
        _check_launches(torch, dev, "device-hang-drill completing steps", rec["launches"])
        rows = pair.job_rows()
        if stepped != 2 or rows != [("finished", 1, 0)] * 3:
            raise AssertionError(f"device-hang-drill: {stepped} completing steps, job rows {rows}")
        if len(step_backs) != 2:
            raise AssertionError(f"device-hang-drill: step-backs {step_backs}")
        rec["collect"] = pair.collect(counters)

        # a prestaged leader init through the watchdog's worker, on a side
        # stream, equals the direct init
        jobs = pair.leader_eds.datastore.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(pair.task.task_id))
        ras = pair.leader_eds.datastore.run_tx(
            lambda tx: tx.get_report_aggregations_for_job(pair.task.task_id, jobs[0].job_id))
        st_init = driver.stage_init(None, pair.task, jobs[0], ras, {r.report_id.data: r for r in pair.reports})
        cols = (st_init.nonce_lanes, st_init.public_parts, st_init.meas, st_init.proof, st_init.blind_lanes)
        direct = engine._leader_init_inner(*cols, allow_pipeline=False)
        on_card = _on_card(torch, dev)
        side = torch.cuda.Stream(device=dev) if on_card else None
        streams = []
        real_step = engine._leader_step

        def step(*a):
            streams.append((threading.current_thread().name,
                            torch.cuda.current_stream(dev) == side if on_card else None))
            return real_step(*a)

        engine._leader_step = step
        try:
            with (torch.cuda.stream(side) if on_card else contextlib.nullcontext()):
                with deadline_scope(time.monotonic() + 60):
                    pre = engine.prestage_leader(*cols)
                    supervised = engine.leader_init(*cols, prestaged=pre)
            _sync(torch, dev)
        finally:
            del engine._leader_step
        same = all(np.array_equal(a, b) for a, b in zip(direct[0].to_numpy(), supervised[0].to_numpy())) and all(
            np.array_equal(a, b) for a, b in zip(direct[2], supervised[2]))
        if (not same or len(streams) != 1 or not streams[0][0].startswith("device-watchdog-")
                or streams[0][1] is False or engine.prestage_stats["used"] < 1):
            raise AssertionError(f"device-hang-drill: the supervised prestaged init: equal {same}, worker and stream "
                                 f"{streams}, prestages {engine.prestage_stats}")
        rec["supervised_prestaged_equal"] = True
        rec["worker_on_caller_stream"] = streams[0][1]
        rec["phase_s"] = time.perf_counter() - t_phase
        return rec
    finally:
        failpoints.release_hangs()
        failpoints.clear()
        pair.close()


def phase_peer_outage_drill(torch, dev, inst, job_size: int = 256):
    """The helper as a failable peer (see the module docstring, phase 18):
    a port leader reaches a port helper through a FaultProxy. A `reset`
    toxic on the request bytes opens the breaker (the step steps back
    `circuit_open`); the tracker then parks the acquirer, whose passes run
    no claim transaction (counted); with the toxic cleared the tracker's
    probe closes the circuit, the job steps (kernels 1 and 2) and the
    collection equals the ground truth."""
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, AggregationJobDriverConfig
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.aggregator.peer_health import PeerHealthConfig, PeerHealthTracker
    from janus_tpu_torch.core.circuit_breaker import CircuitBreakerConfig, OutboundCircuitBreakers, peer_label
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.netsim import FaultProxy
    from janus_tpu_torch.core.retries import Backoff

    t_phase = time.perf_counter()
    proxies = []

    def through_proxy(url: str) -> str:
        from urllib.parse import urlsplit

        proxies.append(FaultProxy("127.0.0.1", urlsplit(url).port).start())
        return proxies[0].url

    pair = DrillPair(torch, dev, inst, job_size, job_size, SEED + 21, endpoint=through_proxy)
    (proxy,) = proxies
    try:
        breakers = OutboundCircuitBreakers(CircuitBreakerConfig(failure_threshold=2, open_cooldown_s=0.5))
        tracker = PeerHealthTracker(breakers, PeerHealthConfig(probe_interval_s=0.1, probe_timeout_s=5.0))
        cfg = AggregationJobDriverConfig(http_backoff=Backoff(initial=0.02, max_interval=0.1, max_elapsed=10.0))
        driver = AggregationJobDriver(pair.leader_eds.datastore, HttpClient(timeout=60), cfg, breakers=breakers,
                                      device=dev, peer_health=tracker)
        step_backs = _count_step_backs(driver)
        ds = pair.leader_eds.datastore
        real_run_tx = ds.run_tx
        claims = []

        def counting_run_tx(fn, name="tx", *a, **kw):
            if name == "acquire_agg_jobs":
                claims.append(name)
            return real_run_tx(fn, name, *a, **kw)

        ds.run_tx = counting_run_tx
        job_driver = JobDriver(JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(), driver.stepper)
        counters = kernel_counters()
        peer = peer_label(pair.task.helper_aggregator_endpoint)
        rec = {"path": "peer-outage-drill", "vdaf": inst.to_dict(), "batch": job_size}

        # the reset toxic opens the breaker; the tracker parks the acquirer
        proxy.set_toxics("up", [{"kind": "reset", "after_bytes": 0}])
        t0 = time.perf_counter()
        if job_driver.run_once() != 1:
            raise AssertionError("peer-outage-drill: the first step did not run")
        rec["failing_step_s"] = time.perf_counter() - t0
        if [s[0] for s in step_backs] != ["circuit_open"] or not tracker.should_park():
            raise AssertionError(f"peer-outage-drill: step-backs {step_backs}, breakers {breakers.status()}")
        t_park = time.monotonic()
        tracker.tick(now=t_park)  # anchors the outage accrual
        pair.advance(10)  # the stepped-back job is claimable again: only the park keeps it
        claims_before = len(claims)
        parked_passes = 0
        for _ in range(3):
            if job_driver.run_once() != 0:
                raise AssertionError("peer-outage-drill: a parked pass claimed a job")
            parked_passes += 1
        rec["claims_skipped"] = parked_passes - (len(claims) - claims_before)
        if rec["claims_skipped"] != parked_passes:
            raise AssertionError(f"peer-outage-drill: {len(claims) - claims_before} claim transactions while parked")
        rec["resets"] = proxy.stats["resets"]

        # the wire heals: the tracker's probe closes the circuit
        proxy.clear()
        deadline = time.monotonic() + 30
        while breakers.state(peer) != "closed" and time.monotonic() < deadline:
            time.sleep(0.05)
            tracker.tick()
        if breakers.state(peer) != "closed":
            raise AssertionError(f"peer-outage-drill: the probe did not close the circuit ({tracker.status()})")
        st = tracker.status()
        rec["parked_s"] = st["peers"][peer]["outage_seconds_total"]
        rec["probes"] = st["peers"][peer]["probes"]
        rec["park_to_heal_s"] = time.monotonic() - t_park
        _sync(torch, dev)
        _zeroed(counters)
        t0 = time.perf_counter()
        if job_driver.run_once() != 1:
            raise AssertionError("peer-outage-drill: the job did not step after the heal")
        rec["healed_step_s"] = time.perf_counter() - t0
        rec["launches"] = _launches(counters)
        _check_launches(torch, dev, "peer-outage-drill healed step", rec["launches"])
        if pair.job_rows() != [("finished", 1, 0)]:
            raise AssertionError(f"peer-outage-drill: job rows {pair.job_rows()}")
        rec["step_backs"] = [[r, d] for r, d, _ in step_backs]
        rec["collect"] = pair.collect(counters)
        rec["phase_s"] = time.perf_counter() - t_phase
        return rec
    finally:
        pair.close()
        proxy.stop()


class _SeededTokens:
    """A `secrets` stand-in whose token_bytes draws from a seeded numpy
    generator: the creator's job ids, and so their shard keys, the same in
    every run."""

    def __init__(self, seed: int):
        import numpy as np

        self._rng = np.random.default_rng(seed)

    def token_bytes(self, n: int) -> bytes:
        return self._rng.bytes(n)


def phase_fleet_drill(torch, dev, inst, per_task: int = 256, job_size: int = 128, bad_rows=(5, 200),
                      creator_steal_after_s: int = 5, driver_steal_after_s: int = 30):
    """The leader as a fleet of two replicas (see the module docstring,
    phase 20): two tasks of `per_task` reports, task A in creator shard 0
    of 2 and task B in shard 1 (their ids drawn from the seed until
    job_shard_key(task_id, b"") % 2 gives both), behind one port leader
    datastore and one port helper. Creator replica `a` sweeps alone
    (`b` is dead): A's jobs at once, B's only once `a` steals B after its
    backlog sat with no owner progress for creator_steal_after_s (mock
    seconds, at most twice that). Then two AggregationJobDrivers with
    acquirer(fleet=), `a` shard 0 and `b` shard 1 of 2 (steal fence
    driver_steal_after_s): `b` claims one job of its shard and is stopped
    while the armed `helper.aggregate` (one hit) fails its step, so the
    drain releaser hands it back (shard_key -1, attempt refunded); `a`
    claims its own shard's jobs and the handed-back job at once (no
    steal), and, past the fence, the rest of shard 1 (each a steal). The
    expected claims come from the jobs' stored shard keys. While a job is
    held, get_lease_holders must name its replica. Every job finishes,
    each of `a`'s steps launches kernels 1 and 2, and both collections
    equal the ground truth. Returns the record."""
    import numpy as np

    from janus_tpu_torch import failpoints
    from janus_tpu_torch.aggregator import aggregation_job_creator as creator_mod
    from janus_tpu_torch.aggregator.aggregation_job_creator import AggregationJobCreator, AggregationJobCreatorConfig
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, AggregationJobDriverConfig
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig, Stopper
    from janus_tpu_torch.config import FleetConfig
    from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.retries import Backoff
    from janus_tpu_torch.datastore.store import job_shard_key, lease_holder_hex

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 22)
    by_shard: dict[int, bytes] = {}
    while len(by_shard) < 2:
        tid = rng.bytes(32)
        by_shard.setdefault(job_shard_key(tid, b"") % 2, tid)
    pair = DrillPair(torch, dev, inst, per_task, job_size, SEED + 23, task_ids=(by_shard[0], by_shard[1]),
                     bad_rows=bad_rows, create=False)
    try:
        ds = pair.leader_eds.datastore
        clock = pair.leader_eds.clock
        task_a, task_b = pair.tasks[0][0], pair.tasks[1][0]
        counters = kernel_counters()
        rec = {"path": "fleet-drill", "vdaf": inst.to_dict(), "reports_per_task": per_task, "job_size": job_size,
               "bad_rows": list(bad_rows), "creator_steal_after_s": creator_steal_after_s,
               "driver_steal_after_s": driver_steal_after_s}

        def jobs_of(task):
            return ds.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(task.task_id), "drill_jobs")

        # creator replica `a` sweeps; `b` is a dead replica and never does
        fleets = {r: dict(replica_id=r, shard_count=2, shard_index=i) for i, r in enumerate("ab")}
        ccfg = AggregationJobCreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=job_size,
                                           max_concurrent_tasks=1)
        creator = AggregationJobCreator(ds, ccfg, fleet=FleetConfig(**fleets["a"],
                                                                    steal_after_secs=creator_steal_after_s))
        backlog_since = clock.now().seconds  # B's reports were stored before the first sweep
        real_secrets = creator_mod.secrets
        # (this seed's four job ids fall two in each driver shard, so the
        # drill has an own claim, a hand-back and a steal to make)
        creator_mod.secrets = _SeededTokens(SEED + 25)
        passes = []
        try:
            passes.append(creator.run_once())
            if passes[0] != per_task // job_size or jobs_of(task_b):
                raise AssertionError(f"fleet-drill: the first sweep made {passes[0]} jobs, "
                                     f"{len(jobs_of(task_b))} of task B")
            while not jobs_of(task_b) and clock.now().seconds - backlog_since <= 2 * creator_steal_after_s:
                pair.advance(1)
                passes.append(creator.run_once())
        finally:
            creator_mod.secrets = real_secrets
        rec["creator_passes"] = passes
        rec["creator_steal_s"] = clock.now().seconds - backlog_since
        rec["jobs_per_task"] = {"A": len(jobs_of(task_a)), "B": len(jobs_of(task_b))}
        if (rec["jobs_per_task"] != {"A": per_task // job_size, "B": per_task // job_size}
                or rec["creator_steal_s"] > 2 * creator_steal_after_s):
            raise AssertionError(f"fleet-drill: creator passes {passes}, jobs {rec['jobs_per_task']}, steal after "
                                 f"{rec['creator_steal_s']} s")

        # the expectations, from the jobs' stored shard keys as created
        keys = dict(ds.run_tx(lambda tx: tx._c.execute("SELECT job_id, shard_key FROM aggregation_jobs").fetchall()))
        shard = {r: {j for j, k in keys.items() if k % 2 == i} for i, r in enumerate("ab")}
        if not shard["a"] or len(shard["b"]) < 2:
            raise AssertionError(f"fleet-drill: the shards hold {len(shard['a'])} and {len(shard['b'])} jobs, "
                                 "not one and two at least")
        rec["jobs_by_shard"] = {r: len(v) for r, v in shard.items()}

        drivers, acquirers, tags, held, step_s = {}, {}, {}, [], []
        for r in "ab":
            fleet = FleetConfig(**fleets[r], steal_after_secs=driver_steal_after_s)
            tags[r] = fleet.holder_tag().hex()
            # b's helper failure is conclusive at once (no retry), as a
            # failure outside the retry loop would be
            backoff = Backoff(initial=0.01, max_interval=0.01, max_elapsed=0.0) if r == "b" else Backoff()
            drivers[r] = AggregationJobDriver(ds, HttpClient(timeout=600), AggregationJobDriverConfig(
                http_backoff=backoff), breakers=OutboundCircuitBreakers(), device=dev)
            acquirers[r] = drivers[r].acquirer(600, fleet=fleet)

        def holding(r):
            def stepper(acquired):
                holders = ds.run_tx(lambda tx: tx.get_lease_holders(), "drill_lease_holders")
                named = [h[3] for h in holders if h[0] == "aggregation" and h[2] == acquired.job_id.data]
                held.append((r, acquired.job_id.data, acquired.shard_key, clock.now().seconds, named,
                             lease_holder_hex(acquired.lease.token)))
                t = time.perf_counter()
                try:
                    drivers[r].stepper(acquired)
                finally:
                    if r == "a":
                        step_s.append(time.perf_counter() - t)
            return stepper

        # b claims one job of its shard, and is stopped while the armed
        # helper.aggregate fails its step: the releaser hands it back
        stopper_b = Stopper()
        jd_b = JobDriver(JobDriverConfig(max_concurrent_job_workers=1), acquirers["b"], holding("b"), stopper_b,
                         releaser=drivers["b"].release_on_drain)
        failpoints.configure("helper.aggregate=error,count=1")
        stopper_b.stop()
        _zeroed(counters)
        try:
            if jd_b.run_once() != 1:
                raise AssertionError("fleet-drill: replica b claimed nothing")
            rec["failpoints"] = {k: {"hits": v["hits"], "fired": v["fired"]}
                                 for k, v in failpoints.status()["failpoints"].items()}
        finally:
            failpoints.clear()
        rec["launches_failed_step"] = _launches(counters)
        (_, handed, _, handed_at, _, _), = held
        row = ds.run_tx(lambda tx: tx._c.execute(
            "SELECT state, lease_token IS NULL, lease_attempts, shard_key FROM aggregation_jobs WHERE job_id = ?",
            (handed,)).fetchall())
        if (handed not in shard["b"] or row != [("in_progress", 1, 0, -1)]
                or drivers["b"].step_backs != {"shutdown_drain": 1} or rec["failpoints"]["helper.aggregate"]["fired"] != 1):
            raise AssertionError(f"fleet-drill: the hand-back: row {row}, step-backs {drivers['b'].step_backs}, "
                                 f"failpoints {rec['failpoints']}")
        t_handback = time.perf_counter()

        # a claims its own shard's jobs and the handed-back one at once, then
        # (past the fence) the rest of shard 1
        jd_a = JobDriver(JobDriverConfig(max_concurrent_job_workers=1), acquirers["a"], holding("a"), Stopper(),
                         releaser=drivers["a"].release_on_drain)
        launches = dict.fromkeys(counters, 0)
        claimed = {}
        for stage in ("at_once", "past_fence"):
            if stage == "past_fence":
                pair.advance(driver_steal_after_s + 1)
            claimed[stage] = []
            while True:
                _sync(torch, dev)
                _zeroed(counters)
                n = jd_a.run_once()
                if not n:
                    break
                step = _launches(counters)
                _check_launches(torch, dev, f"fleet-drill step {len(step_s)}", step)
                launches = {k: launches[k] + step[k] for k in launches}
                claimed[stage].append(held[-1][1])
                if held[-1][1] == handed:
                    rec["handback_claim_mock_s"] = held[-1][3] - handed_at
                    rec["handback_claim_wall_s"] = time.perf_counter() - t_handback
        want = {"at_once": shard["a"] | {handed}, "past_fence": shard["b"] - {handed}}
        if {k: set(v) for k, v in claimed.items()} != want:
            raise AssertionError(f"fleet-drill: replica a claimed {claimed}, not {want}")
        status = {r: acquirers[r].status() for r in "ab"}
        rec["claims"] = {r: {"own": st["jobs"] - st["steals"] - st["handbacks"], "stolen": st["steals"],
                             "handed_back": st["handbacks"], "claim_tx": st["claim_tx"]} for r, st in status.items()}
        want_claims = {"a": {"own": len(shard["a"]), "stolen": len(shard["b"]) - 1, "handed_back": 1},
                       "b": {"own": 1, "stolen": 0, "handed_back": 0}}
        if {r: {k: c[k] for k in ("own", "stolen", "handed_back")} for r, c in rec["claims"].items()} != want_claims:
            raise AssertionError(f"fleet-drill: claims {rec['claims']}, not {want_claims}")
        wrong = [h for h in held if h[4] != [tags[h[0]]] or h[5] != tags[h[0]]]
        if wrong:
            raise AssertionError(f"fleet-drill: lease holders not the stepping replica: {wrong} ({tags})")
        rec["holders"] = {r: tags[r] for r in "ab"}
        if pair.job_rows() != [("finished", 1, 0)] * len(keys):
            raise AssertionError(f"fleet-drill: job rows {pair.job_rows()}")
        rec["steps"] = len(step_s)
        rec["step_s_p50"] = _percentile(step_s, 0.5)
        rec["step_s_max"] = max(step_s)
        rec["launches"] = launches
        rec["lease_conflicts"] = ds.status()["lease_conflicts"]
        rec["collect"] = [pair.collect(counters, i) for i in range(2)]
        rec["phase_s"] = time.perf_counter() - t_phase
        return rec
    finally:
        failpoints.clear()
        pair.close()


def _host_words(torch, v) -> tuple:
    """A host value (u64 lanes, limbs or masks as arrays, tuples of them,
    or a list of field elements as Python ints) as a tuple of int64
    tensors of its 64-bit words, for max_abs_err."""
    import numpy as np

    if isinstance(v, (tuple, list)) and v and not isinstance(v[0], int):
        return tuple(w for x in v for w in _host_words(torch, x))
    if isinstance(v, list):
        lo = np.array([x & (2**64 - 1) for x in v], dtype=np.uint64)
        hi = np.array([x >> 64 for x in v], dtype=np.uint64)
        return tuple(torch.from_numpy(a.view(np.int64)) for a in (lo, hi))
    return (torch.from_numpy(np.ascontiguousarray(np.asarray(v).astype(np.uint64)).view(np.int64)),)


def phase_mesh(torch, dev, inst, batch: int, bad_rows):
    """Multi-device serving in one process, the engine (see the module
    docstring, phase 19): mesh-sumvec."""
    import numpy as np

    from janus_tpu_torch.aggregator import engine_cache as ec
    from janus_tpu_torch.convert import step_args_to_numpy
    from janus_tpu_torch.messages import Duration, Interval, Time
    from janus_tpu_torch.ops import cuda_build
    from janus_tpu_torch.vdaf.registry import prio3_batched
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    t_phase = time.perf_counter()
    devices, distinct = _mesh_devices(torch, dev)
    counters = kernel_counters()
    fast = ("keccak_single_block", "expand_f128")
    p3 = prio3_batched(inst, devices[0])
    meas = np.asarray(random_measurements(inst, batch, np.random.default_rng(SEED + 19)))
    t0 = time.perf_counter()
    args, _ = make_report_batch(inst, meas, seed=SEED + 19, device=devices[0])
    args = list(args)
    args[3] = _bump_rows(torch, p3, args[3], bad_rows)
    nonce, parts, lmeas, proof, blind0, hseed, blind1 = step_args_to_numpy(args)
    args = None
    _sync(torch, dev)
    shard_s = time.perf_counter() - t0
    ok = np.ones(batch, dtype=bool)
    k = 2
    iv = Interval(Time(0), Duration(3600))
    single = ec.EngineCache(inst, VERIFY_KEY, device=devices[0])
    meshed = ec.EngineCache(inst, VERIFY_KEY, devices=devices)
    if (meshed.dp, meshed.sp) != (2, 1) or meshed.mesh is None or meshed.mesh.distinct != distinct:
        raise AssertionError(f"mesh-sumvec: geometry {meshed.mesh_status()}")

    def serve(eng):
        """Both inits, both parties' pending sums merged into one slot a
        bucket (the slot then holds the plaintext sum), the take and both
        masked aggregates: (seconds, host values)."""
        _sync(torch, dev)
        t0 = time.perf_counter()
        out0, seed0, ver0, part0 = eng.leader_init(nonce, parts, lmeas, proof, blind0)
        out1, mask, prep = eng.helper_init(nonce, parts, hseed, blind1, ver0, part0, ok)
        bucket_idx = np.where(mask, np.arange(batch) % k, -1).astype(np.int32)
        for out in (out0, out1):
            eng.resident_merge([((b"mesh", b"", bytes([j])), j, 0, iv) for j in range(k)],
                               eng.aggregate_pending(out, bucket_idx, k))
        taken = sorted((r["key"], r["share"]) for r in eng.resident_take())
        aggs = (eng.aggregate(out0, mask), eng.aggregate(out1, mask))
        _sync(torch, dev)
        s = time.perf_counter() - t0
        return s, {"out0": out0.to_numpy(), "seed0": seed0, "ver0": ver0, "part0": part0, "out1": out1.to_numpy(),
                   "mask": mask, "prep": prep, "agg": [list(a) for a in aggs], "resident": [t[1] for t in taken]}

    # turns: single, mesh, mesh, single; the first mesh serve is the main
    # path, counts at 0 just before it, read just after
    single_s, want = serve(single)
    _zeroed(counters)
    cuda_build.reset_shard_launches()
    mesh_s, got = serve(meshed)
    launches = _launches(counters)
    by_shard = cuda_build.shard_launches()
    mesh_s2, got2 = serve(meshed)
    single_s2, want2 = serve(single)
    _check_launches(torch, dev, "mesh-sumvec", launches, fast)
    if _on_card(torch, dev):
        for kernel in fast:
            shards = by_shard.get(kernel, {})
            if sorted(shards) != [0, 1] or min(shards.values()) == 0:
                raise AssertionError(f"mesh-sumvec: {kernel} did not launch on every shard ({by_shard})")
    errs = {key: max(max_abs_err(torch, _host_words(torch, other[key]), _host_words(torch, want[key]))
                     for other in (got, got2, want2)) for key in want}
    valid = np.ones(batch, dtype=bool)
    valid[list(bad_rows)] = False
    accepted = (int(got["mask"].sum()), int(want["mask"].sum()))
    if accepted != (batch - len(bad_rows),) * 2 or any(errs.values()):
        raise AssertionError(f"mesh-sumvec: accepted {accepted}, errors {errs}")
    flat = meas.reshape(batch, -1).astype(object)
    truth = [[int(x) % p3.tf.MODULUS for x in flat[valid & (np.arange(batch) % k == j)].sum(axis=0)]
             for j in range(k)]
    if got["resident"] != truth:
        raise AssertionError("mesh-sumvec: the resident take is not the accepted reports' sum")
    return {"path": "mesh-sumvec", "vdaf": inst.to_dict(), "devices": [str(d) for d in devices],
            "distinct_devices": distinct, "reports": batch, "bad_rows": list(bad_rows), "dp": meshed.dp,
            "sp": meshed.sp, "accepted": batch - len(bad_rows), "max_abs_err": 0, "max_abs_err_by_value": errs,
            "shard_s": shard_s, "launches": launches, "launches_by_shard": by_shard,
            "serve_s": {"single": [single_s, single_s2], "mesh": [mesh_s, mesh_s2]},
            "turn_order": ["single", "mesh", "mesh", "single"],
            "lane": ec._MESH_QUEUE.status(), "phase_s": time.perf_counter() - t_phase}


def _mesh_devices(torch, dev):
    """Two distinct cards where the machine has two, else the one card
    twice (or the CPU twice in a rehearsal); and whether they differ."""
    dev = torch.device(dev)
    if not _on_card(torch, dev):
        return [dev, dev], False
    if torch.cuda.device_count() >= 2:
        return [torch.device("cuda", i) for i in range(2)], True
    return [torch.device("cuda", 0)] * 2, False


def phase_mesh_step(torch, dev, big, args, want, bad_count: int):
    """mesh-sumvec100k (see the module docstring, phase 19): the sharded
    two-party step on the batch the single-device path just stepped
    (`args`, its outputs `want`), at the geometry two devices choose for
    the engine's vector-axis threshold."""
    from janus_tpu_torch.aggregator import engine_cache as ec
    from janus_tpu_torch.ops import cuda_build
    from janus_tpu_torch.parallel import api
    from janus_tpu_torch.vdaf.registry import prio3_batched

    t_phase = time.perf_counter()
    devices, distinct = _mesh_devices(torch, dev)
    counters = kernel_counters()
    circ = prio3_batched(big, devices[0]).circ
    geometry = api.choose_mesh_geometry(len(devices), circ.input_len, circ.output_len, ec.EngineCache.SP_MIN_INPUT_LEN,
                                        ec.MIN_BUCKET)
    if geometry != (1, 2):
        raise AssertionError(f"mesh-sumvec100k: geometry {geometry}, want (1, 2)")
    mesh = api.make_mesh(*geometry, devices)
    _zeroed(counters)
    cuda_build.reset_shard_launches()
    t0 = time.perf_counter()
    agg0, agg1, count = api.sharded_two_party_step(big, VERIFY_KEY, mesh)(*args)
    _sync(torch, dev)
    step_s = time.perf_counter() - t0
    launches = _launches(counters)
    _check_launches(torch, dev, "mesh-sumvec100k", launches, ("keccak_single_block", "expand_f128"))
    err = max(max_abs_err(torch, tuple(a), tuple(b)) for a, b in ((agg0, want[0]), (agg1, want[1])))
    batch = args[0].shape[0]
    if err or int(count) != int(want[2]) or int(count) != batch - bad_count:
        raise AssertionError(f"mesh-sumvec100k: max_abs_err {err}, counts {int(count)} / {int(want[2])}")
    return {"path": "mesh-sumvec100k", "vdaf": big.to_dict(), "devices": [str(d) for d in devices],
            "distinct_devices": distinct, "reports": batch, "dp": geometry[0], "sp": geometry[1],
            "accepted": int(count), "max_abs_err": err, "step_s": step_s, "launches": launches,
            "launches_by_shard": cuda_build.shard_launches(), "phase_s": time.perf_counter() - t_phase}


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
    from janus_tpu_torch import metrics
    from janus_tpu_torch.vdaf.registry import VdafInstance

    dev = torch.device("cuda")
    # janus_build_info's backend label: the card this run serves on
    metrics.register_build_info(torch.cuda.get_device_name(0))
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
    # (the profile of one draft-sumvec step, 43.5 s, went when the pipeline
    # phases took the script past 480 s: ROADMAP's second cut, after
    # fixedpoint's batch)
    # long vectors and the last circuits: the north star SumVec(100000, 16)
    # on the streamed query in both XOF modes, and FixedPointVec(1000, 16)
    big = VdafInstance.sum_vec(100_000, 16)
    big_plan = (61_936, 49, 26)
    # (batches halved from 128, 64 and 64: each phase ran past 60 s at those;
    # halved again from 64 and 32 when the sparse phases took the whole
    # script past 480 s, and sumvec100k again from 32 when it stayed past:
    # the device shard is most of it. The draft step's time does not
    # follow its batch (its sponge chains run one after another), so its
    # batch stays)
    runs = (
        ("sumvec100k", big, 16, (5, 9, 13), fast, 1, 16, 1, 3, big_plan, 4, True),
        ("draft-sumvec100k", VdafInstance("sumvec", bits=16, length=100_000, xof_mode="draft"), 16, (3, 9, 13),
         ("keccak_sponge",), 1, 16, 0, 24, big_plan, 2, False),
        # (cut from 1,024 reports when the pipeline phases took the script
        # past 480 s: ROADMAP's first cut)
        ("fixedpoint", VdafInstance.fixed_point_vec(1000, 16), 256, (5, 100, 200), fast, 3, 256, 4, 24, None, 0,
         False),
    )
    out = mesh_big = None  # the last phase's arguments leave the card before the next
    for name, inst, batch, bad, kernels_of_path, reps, chunk, small, small_rounds, plan, ident, on_card in runs:
        out = phase(
            name, run_path, torch, dev, name, inst, batch, bad, kernels_of_path, reps, chunk, small, small_rounds,
            plan, ident, on_card,
        ) if not failed else None
        if out is not None:
            paths[name] = out[0]
            if name == "sumvec100k":
                # mesh-sumvec100k (phase 19) on the batch just stepped: its
                # single-device outputs are the reference
                _, args, want = out[1]
                mesh_big = phase("mesh-sumvec100k", phase_mesh_step, torch, dev, inst, args, want, len(bad))
                args = want = None
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
                (5, 300, 1000), fast, 8, True) if not failed else None
    if out is not None:
        observability = out.pop("observability")
        serves[out["path"]] = out
        emit({"upload_drive": out})
        emit({"observability": observability})
    # the deployed process pair: the five binaries booted from config on
    # this card, as an operator runs them (this process's cached blocks go
    # back to the card first: the two device processes size their buckets
    # from the card's total memory)
    torch.cuda.empty_cache()
    out = phase("binaries-sumvec", phase_binaries, torch, dev, VdafInstance.sum_vec(1000, 16), 8, 1016,
                (5, 300, 1000)) if not failed else None
    if out is not None:
        emit({"binaries": out})
    out = phase("upload-drive-sparse", phase_upload_drive, torch, dev, sparse_inst, 8, 1016, (5, 300, 1000),
                fast) if not failed else None
    if out is not None:
        serves[out["path"]] = out
        emit({"upload_drive": out})
    # the leader's stage pipeline with prestaged columns, resident
    # accumulators and cross-task coalescing: two SumVec(1000, 16) tasks,
    # then block-sparse SumVec merged into its dense slot by kernel 4
    for name, inst, keys, bad, runs, check_rows in (
        ("sumvec", VdafInstance.sum_vec(1000, 16), (VERIFY_KEY, VERIFY_KEY_B), ((0, 5), (0, 300), (1, 100)),
         ((1, 4), (4, 4)), 128),
        ("sparse", sparse_inst, (VERIFY_KEY,), (), ((1, 4),), 0),
    ):
        out = phase(f"pipeline-resident-{name}", phase_pipeline_resident, torch, dev, inst, keys, 512, 128, bad,
                    runs, check_rows) if not failed else None
        if out is not None:
            out["path"] = f"pipeline-resident-{name}"
            serves[out["path"]] = out
            emit({"pipeline_resident": out})
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
    # the card and the helper as failable peers
    for name, fn, key in (("device-hang-drill", phase_device_hang_drill, "device_hang_drill"),
                          ("peer-outage-drill", phase_peer_outage_drill, "peer_outage_drill")):
        out = phase(name, fn, torch, dev, VdafInstance.sum_vec(1000, 16)) if not failed else None
        if out is not None:
            serves[out["path"]] = out
            emit({key: out})

    # the leader as a fleet of two replicas: shard-affine claims, the
    # creator's and the drivers' steals, a drain hand-back at a fault site
    out = phase("fleet-drill", phase_fleet_drill, torch, dev, VdafInstance.sum_vec(1000, 16)) \
        if not failed else None
    if out is not None:
        serves[out["path"]] = out
        emit({"fleet_drill": out})

    # multi-device serving in one process (mesh-sumvec100k ran after
    # sumvec100k, on its batch; the engines serve in turns single, mesh,
    # mesh, single)
    out = phase("mesh", phase_mesh, torch, dev, VdafInstance.sum_vec(1000, 16), 1024, (5, 300, 1000)) \
        if not failed else None
    if out is not None and mesh_big is not None:
        serves[out["path"]] = out
        serves[mesh_big["path"]] = mesh_big
        emit({"mesh": {"devices": out["devices"], "distinct_devices": out["distinct_devices"],
                       "lane": out["lane"], "phase_s": out["phase_s"] + mesh_big["phase_s"],
                       "paths": [out, mesh_big]}})

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
            "device_ms": main_case.get("device_ms"),
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
