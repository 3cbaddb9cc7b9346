#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``waffle_con_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, as the check runs it
    python3 chip_smoke.py --phases kernel --small   # build + quick check
    python3 chip_smoke.py --phases replay_kernel,late_main,late_oracle
    python3 chip_smoke.py --phases arena_kernel --small  # arena build + check
    python3 chip_smoke.py --phases dual_main --profile [--arena off]
    python3 chip_smoke.py --phases main,dual_main,priority_main,late_main,native_baseline
    python3 chip_smoke.py --phases gang_kernel,gang_main,plan_gate
    python3 chip_smoke.py --phases main,dual_main,priority_main,late_main,checkpoint_main,obs_main
    python3 chip_smoke.py --phases branch_kernel --small  # branch step build + check
    python3 chip_smoke.py --phases main,dual_main,priority_main,late_main,plan_gate,branch_kernel,checkpoint_main
    python3 chip_smoke.py --phases main,dual_main,priority_main,native_baseline,runtime_main
    python3 chip_smoke.py --phases mesh_kernel --small  # sharded step check
    python3 chip_smoke.py --phases main,priority_main,mesh_kernel,mesh_main
    python3 chip_smoke.py --phases serve_kernel,serve_main
    python3 chip_smoke.py --phases serve_main,replica_main
    python3 chip_smoke.py --phases serve_main,cache_main
    python3 chip_smoke.py --phases serve_main,procs_main

Phases, one line each (every failure exits non-zero):

1. device: the card (``nvidia-smi``), torch, and the ``nvcc`` build of
   ``waffle_con_tpu_torch/csrc/*.cu`` (one compiler per source, in
   parallel, linked into one library); then ``build_cache``: the kernel
   library and the C++ engines' library loaded, each checked first
   against the build directory's manifest (``utils/cache.py``:
   ``verified``, ``sealed``, or ``quarantined`` and rebuilt).
2. kernel: the CUDA run kernel (one thread-block cluster per launch)
   against its plain PyTorch version on the card, every output compared
   bitwise, on a small geometry (R=16, E=8; one read; a band of
   W=2050), the north-star geometry (R=256, W=514, 10 kb
   reads), the dual north star's (R=64, W=258, 5 kb reads: the dual
   search's first launch, a launch that loses the pop, records at the
   reads' ends) and the cluster's edges (300 reads, a CTA of inactive
   reads, the grown band W=1026, 1,024 reads with the band in device
   memory, records reached CTA by CTA); each line gives the launch plan
   (cluster, threads per CTA, band placement) and times per step of both.
3. main: the north-star search — 256 reads x 10 kb at 1 % error,
   ``min_count=64``, ``initial_band=216`` — through ``ConsensusDWFA`` on
   ``cuda``; the consensus must equal the truth, the run kernel must have
   taken every run (its launch counter > 0, the plain loop never called).
4. oracle: 16 reads x 1 kb at 2 %: the ``"python"`` oracle and ``"torch"``
   on ``cuda`` give byte-identical results.
5. dual_kernel: the CUDA dual run kernel (``csrc/run_extend_dual.cu``,
   one thread-block cluster per launch) against its plain PyTorch
   version, every output and both slots' rows compared bitwise, on a
   small geometry (R=16, E=8; one read), the dual north-star geometry
   (R=64, W=258, 5 kb reads: launches of more than 1,000 steps, a
   2-step launch for the fixed cost, a locked side, weighted votes on
   split sides) and the cluster's edges (60 reads, a CTA whose reads are
   inactive on one side, pruning outside rank 0, records reached CTA by
   CTA, 256 reads at W=1026 with the band in device memory); each line
   gives the launch plan and times per step of both.
6. dual_main: the dual north star — 64 reads x 5 kb at 1 %, two
   haplotypes 3 SNPs apart, ``min_count=16``, ``initial_band=116`` —
   through ``DualConsensusDWFA`` on ``cuda``; both haplotypes must come
   back, the dual kernel must have taken every dual run (its launch
   counter > 0, neither plain loop called).  ``speculator_cost`` times
   three more warm searches with the frontier speculator and three with a
   stand-in that never gangs, alternating: the speculation layer's host
   µs a pop.
7. dual_oracle: 16 reads x 1 kb, 2 SNPs, 2 %: the dual engine's
   ``"python"`` oracle and ``"torch"`` on ``cuda`` give byte-identical
   results, scores included.
8. priority_main: the priority north star — 32 two-level chains (1 kb
   reads of one truth, then 2 kb reads of two haplotypes two SNPs
   apart), ``min_count=8``, ``initial_band=56`` — through
   ``PriorityConsensusDWFA`` on ``cuda``, one shared scorer per chain
   level seen by each group through a ``SubsetScorer``; both groups'
   chains must equal the truth, two scorers must be built (and freed),
   both kernels must have launched (neither plain loop called).
9. priority_oracle: the twelve ``tests/data`` fixtures and two draws of
   16 chains x 1 kb at 2 %: the priority engine's ``"python"`` oracle
   and ``"torch"`` on ``cuda`` give equal results, scores included.

10. late_main: the late-read deployment — the single north star's 256
    reads x 10 kb at 1 %, every read ``i % 4 == 3`` (64 reads) cut at a
    start from ``default_rng(7).integers(1000, 5000)`` and added with
    ``add_sequence_offset``, ``min_count=64``, no ``initial_band`` (the
    band starts at E=8 and grows), the default ``offset_window`` and
    ``offset_compare_length`` of 50 — through ``ConsensusDWFA`` on
    ``cuda``, cold then warm; the consensus must equal the truth, every
    activation must take the offset-scan kernel (its launches equal the
    scorer's ``offset_scan_calls``), the column replay and run kernels
    must have launched, 64 activations and a band growth must have
    happened, and no plain twin may have run.  The cold search records
    the inputs of its first three offset scans, its first three
    activations and every growth replay; a second warm search times the
    scorer's offset, activation and growth calls; the warm wall and the
    device profile come from a third search with nothing wrapped.  It
    prints the walls, pops, launches, activations, growth events,
    replayed columns, the final W, the activations' and growths' share
    of the timed wall and the device time by kernel.
11. replay_kernel: the offset scan (``csrc/offset_scan.cu``, bit
    vectors) and the column replay (``csrc/col_replay.cu``, cells in
    registers) against their plain PyTorch twins on the card, every
    output compared bitwise: scans of the default window (P=64, M=64,
    m=50, one thread a position), the same with the whole head compared
    (m=64), one position (P=1), the plan's edges m=65 and m=129 (groups
    of 2 and 4 lanes), a wide window with the wildcard (P=128, M=256),
    long heads (m=1500; m=1100 at M=32768: a warp a position; m=2100:
    the column in shared memory; m=7000: Peq in device memory), and the
    deployment's first three; one row caught up over 50, 100, 5,000 and
    no columns (the offset at the branch's end, and past it), an
    overflow at E=8 that must commit nothing, one row on a CTA (W=2050),
    on clusters of 4 and 8 CTAs (W=32770, W=65538) and on the
    device-memory last resort (W=139266), and the deployment's first
    three activations; growth replays of 16 x 256 rows to W=34 and 16 x
    128 to W=66 at clen 300 (more rows than the card has warps), to
    W=258 at clen 6,000 with mixed anchors, inactive rows and free
    slots, to W=2050 (a CTA a row), W=32770 and W=65538 (a cluster a
    row), W=139266 (device memory), and every growth of the deployment; each line gives
    the launch geometry (the placement included), the kernel's time
    (CUDA events around the call), its device time (events around
    launches queued behind a spin kernel, the host's launch cost left
    out),
    the twin's time and the bound.
12. late_oracle: the ``"python"`` oracle and ``"torch"`` on ``cuda`` give
    byte-identical results, scores included, with late reads and the
    default band: 16 reads x 1 kb at 2 % with every 4th read cut at
    100-500 on the single engine, the same shape with 2 SNPs on the dual
    engine, and the ``length_gap_001`` fixture.

13. arena_kernel: the K-node pop arena (``csrc/arena.cu``, one
    thread-block cluster) against its plain twin on the card, every field
    of the packed output and every store row some node owns compared
    bitwise: the first three arena calls of ``dual_main``'s cold search
    and the first of ``priority_main``'s (a group's call through its
    ``SubsetScorer``), recorded as they ran, the calls of ten small
    searches chosen to reach every stop code 1-5, a discard on the
    device, creation in both modes, a full creation pool (``stop_diag``
    without flag 8), mixed offsets, weighted, ``mc_dyn`` and L2 votes,
    W = 514 and 2050 and the largest cluster (16 CTAs), and three of
    those calls cut to 7, 13 and 33 reads (a one-CTA cluster, odd R); the
    phase fails when a feature or one of those plans is not reached.
    Each line gives the plan, the kernel's time (CUDA events around the
    launch), the twin's and the bound.  The first
    recorded ``dual_main`` and ``priority_main`` calls also run the
    kernel's profiled variant: one ``arena_breakdown`` line each, the µs
    an event of each part (tournament and decisions, row step, commit
    write-back, record fold, finish).

14. native_baseline (run after ``late_main``, whichever order the phases
    are named in): the port's C++ engines (``waffle_con_tpu_torch/native``,
    built here with ``g++``: build seconds, ``g++ --version``, the host's
    CPU model and core count) run twice on each deployment the main
    phases ran (``main``, ``dual_main``, ``priority_main``, ``late_main``:
    the same draws and configs; the late deployment with its offsets and
    no band), on the card's host; each result must equal that phase's
    ``"torch"`` result on ``cuda`` byte for byte (sequences and scores;
    both haplotypes and the read assignment; every chain and the group
    indices).  The port's ``"torch"`` search on ``cuda`` runs as many
    warm times as the C++ engine, alternating with it.  One line per
    deployment: ``cpp_s`` and ``torch_warm_s`` (each run's wall) and
    ``cpp_over_torch`` (the faster C++ run over the faster warm search).
    Then 16 x 1 kb at 2 % through the single and the dual engine on
    ``backend("native")`` against ``"torch"`` on ``cuda``.

15. plan_gate: a shape a kernel's launch planner refuses is "not
    engaged", never an exception mid-search: a single draw of 8 reads x
    600 symbols over 129 symbols, two haplotypes, and a dual draw of 256
    reads x 320 symbols over 256 symbols, two haplotypes, on ``cuda``
    (the arena takes at most 128 symbols, so it is refused on both and
    the pops take the run kernels; ``plan_run_dual`` takes R=256 at
    A=256 on 8 warps a CTA), each equal to the ``"python"`` oracle and the
    C++ engine; each line prints the refusal counters
    (``plan_refused_arena``, ``_run``, ``_run_dual``, ``_ragged``), and
    the run kernels' must stay 0.  The main phases print the same
    counters and fail unless all four are 0.
16. gang_kernel: the frontier-gang kernel (``csrc/run_ragged.cu``, one
    thread-block cluster per member) against its plain twin on the card
    and against a solo ``run_extend`` launch of each member from the same
    state, every deposit compared bitwise: 2, 4 and 8 branches of the
    single north star's store (R=256, W=514; truth prefixes, forced right
    and wrong first symbols, unforced), 4 of the dual north star's
    (R=64, W=258) and 4 of the priority north star's level 1 (R=32,
    W=130), 4 at the run kernel's device-memory band (R=1024, W=514, one
    of them out of step with its slot), and small cases for the step cap
    (code 4), band overflow (code 5), a lost pop and budget (code 3), L2
    and the wildcard.  Each line
    gives the plan, the clusters that fit on the card at once, ms a
    launch and µs a step of the longest member, the summed time of the
    members' solo launches, the twin's time and the bound.
17. gang_main (after ``native_baseline``): every deployment the main
    phases ran, at the default (adaptive) frontier width, at
    ``frontier_width=8`` and at 1, byte-equal to each other and to the C++
    engine, then the low-coverage draw (16 reads x 5 kb at 2 %,
    ``min_count=4``) and the JAX package's gang test draws (8 x 300 bp at
    2 %; 2 x 5 x 250 bp at 4 %): one line per search with the gang
    counters, gang launches, the warm wall and the device ms.  The phase
    fails when no search launched the gang kernel.

18. checkpoint_main (after the main phases): every tracked deployment
    they ran, snapshotted at half its polls and resumed on ``cuda``: an
    uninterrupted search under a ``CheckpointController`` gives the poll
    count, a second one is preempted there (``SearchPreempted``), the
    checkpoint goes through ``to_json`` / ``from_json`` and resumes; the
    resumed result must equal the uninterrupted one and the C++
    engine's, byte for byte, no plain twin may run and no planner may
    refuse.  One line per deployment: checkpoint bytes, restored nodes,
    the restore's seconds split into root, replay (``push_many`` calls)
    and activate (column-replay launches, timed between synchronisations),
    the resumed search's wall and its launches by kernel.  Then a
    ``"python"`` checkpoint of a small dual draw resumes on ``cuda`` to the
    same result, and a tampered body and a corrupted read are refused.
19. obs_main: the dual and priority north stars warm with the
    observability plane on (metrics, tracer with the ``torch.profiler``
    bridge, audit capture) and off, alternating off, on, on, off: the
    results and every kernel's launch count must be identical; each line
    gives the wall, the Chrome trace's spans, metric series and audit
    records.  One more search with the plane on under ``torch.profiler``
    counts the kernel launches inside the ``search`` range (all must be)
    and inside ``dispatch:*`` ranges.  On a small dual draw the ``cuda``
    search's audit log ``diff_logs`` identical to the ``"python"``
    search's and the lockstep shadow is clean; a seeded ``flip_vote`` on
    a small single draw aborts the shadow exactly once.

20. branch_kernel (run before ``checkpoint_main``): the branch store's
    life-cycle calls (``csrc/branch_step.cu``: root, copy, advance,
    stats, finalize, deactivate) against their plain twins on the card,
    every output and every store field compared bitwise: pushes at the
    single north star's restore shape (R=256, W=514, every read active
    and none), the dual restore's largest batch (92 slots in place, R=64,
    W=258), an expansion and a cycle of rows each writing the slot the
    next one reads (gather before scatter), a batch with a row that
    overflows the band at E=8 (nothing may commit), ``plan_gate``'s
    alphabet (A=256, R=256, 12 clones pushed, the wildcard), W=2050 and
    W=139266, copies without stats, root, stats, finalize and
    deactivate; several cases also forced onto the slab plan, held
    bitwise and timed.  Each line gives the plan (``one_launch`` or
    ``slab``; the north star's advance, copy, stats and finalize must be
    one launch on ``one_launch``, W=2050 and W=139266 must take
    ``slab``), the launches a call, the kernel's ms a call (CUDA events
    around it, the host's work and its copy of the result included), the
    host wall a call (1,000 calls, the store restored every 32 outside
    the clock, so every push commits), the device ms a call (``torch.profiler``: every device
    activity, and the kernels alone), the twin's ms and the bound.  Then
    1,000 in-place restore pushes with no read active through
    ``TorchScorer.push_many`` (``north_star/replay_1000``), held to the
    CPU twins.  The branch step is what every search roots, pushes,
    clones, deactivates and reads stats through, so every main path
    counts its launches (``main``, ``dual_main``, ``priority_main``,
    ``late_main``, ``plan_gate``, ``checkpoint_main``) and fails if its
    twins ran; ``checkpoint_main``'s restore split gives the time inside
    the branch-step calls and the host's ``_stats_batch``.
21. runtime_main (after the main phases and ``native_baseline``): the
    runtime plane on the single, dual and priority north stars.
    Supervised with no fault, each search equals the unsupervised one
    and the C++ engine's byte for byte, with no demotion and every
    kernel's launches equal to the unsupervised search's; the line gives
    both warm walls (alternating) side by side and the wall with the
    dispatch timer on.  ``device_loss`` at the middle ``"torch"`` run
    call demotes once to native; ``garbage`` and ``timeout`` there are
    retried without a demotion; with ``repromote_after`` the single and
    priority searches go back to ``"torch"`` and the line gives the
    launches after the re-promotion (> 0); the dispatch budget pinned at the search's own
    count passes in strict mode and one fewer raises.  On the single north
    star an armed ``pallas_compile`` raises unsupervised and demotes
    supervised; a small draw demotes torch -> python.  Every result is
    held to the unsupervised and the C++ one, and every line carries the
    card's name and power limit.

The JAX package's megastep (``_j_run_mega``, an XLA loop under a per-call
step budget) is the run kernel itself here: one launch runs to the first
event, under the caller's ``max_steps``.  ``kernel`` holds a launch capped
at 100 steps (``north_star/step_cap``, code 4) bitwise against the plain
loop.

``main``, ``dual_main``, ``priority_main`` and ``late_main`` also give
the arena's launches, plan and counters (calls, events, stop codes,
discards, creations); ``dual_main`` and ``priority_main`` fail when the
arena never launched, and every path fails when a plain twin ran.
``--arena off`` switches the engines' arena off (the previous slice's
path) for comparisons, ``--profile`` adds a ``cProfile`` of one more
warm ``dual_main`` search.

Both run-kernel phases also hold their kernel on a priority-engine
group's shape (``subset/`` cases): the reads outside the group inactive
from the root, interleaved across the CTAs or filling whole CTAs.
``late_main`` runs before ``replay_kernel``, which also holds the
deployment's own recorded calls (scans, activations and growths).

22. mesh_kernel: the sharded column step (``parallel/mesh.py``'s
    ``sharded_col_step``: one ``csrc/branch_step.cu`` call a shard on a
    one-slot store of the shard's state, commit forced, the partials
    gathered by the kernel and added in shard order on the first device)
    at 1, 2 and 4 shards (round-robin over the cards: on one card the
    shards share it), every output bitwise against the plain version
    (``advance_plain`` a shard, the same sum) and against the 1-shard
    (unsharded) branch step: the single north star's column (R=256,
    W=514, A=4, 5,000 columns in) and a step that overflows at E=8.
    Each line gives the shards a device, ms a step (CUDA events around
    the call, host work included), its device ms (``torch.profiler``:
    every activity, and the branch-step kernels alone), the plain
    version's ms and the bound.  Then the shard instances of the run,
    dual-run and arena kernels (``run_extend_shards_cuda`` and kin: one
    launch for every shard of a store on one card) at 1, 2 and 4 shards of
    ``cuda:0``, each launch bitwise against its plain version on the same
    shards and against the unsharded kernel on the unsharded store: the
    single north star's root run capped at 100 steps, a dual north-star
    run (300 steps from just past the second SNP), the dual north star's
    first arena call, and a run whose band of E=8 overflows.  Each line
    gives the events ms and device ms of the sharded and the unsharded
    launch, the plain version's ms and the unsharded kernel's bound.
23. mesh_main: the engines through ``mesh_shards=4`` (a pinned
    ``DeviceSet`` of 4 shard devices, round-robin over the cards): the
    single north star (cold and warm), the priority north star and the
    dual north star (64 reads x 5 kb).  Each result equals the unsharded
    ``"torch"`` search's and the C++ engine's byte for byte; on
    co-resident shards the run, dual-run and arena kernels launch their
    shard instances as often as the unsharded search launches the
    kernels, the gang kernel 0 times, no plain version runs and no
    planner refuses.  One line a draw: the placement, the sharded and
    unsharded walls, launches by kernel, shard steps.

24. serve_kernel: the gang kernel (``csrc/run_ragged.cu``) with members
    from different branch stores in one launch, in place as the serving
    pool runs it: ``mixed3`` (R=32, W=130; R=64, W=258; R=256, W=514; a
    forced first symbol), ``mixed4/global_band`` (the three and R=1024,
    W=514 with its band in device memory), ``constants`` (L2, a
    wildcard alphabet of 5, early termination with cut reads, a lost
    budget, a member out of step with its slot) and
    ``gang10/two_launches`` (ten stores: two consecutive launches).
    Every member's packed output and slot rows bitwise against the plain
    version on the card and against its solo run-kernel launch from the
    same state; each line gives the launch plan and each member's, ms a
    launch (CUDA events around the call, and device time: events around
    launches queued behind a spin kernel), the
    members' solo launches summed, the plain version's ms and the bound.
25. serve_main: the in-process serving path — one ``ConsensusService``
    on the card (8 workers, a queue of 16, a pool of 4,096 rows of 8 a
    page, E 256, L 10,240, C 12,288, gang 8) answers 16 jobs submitted
    at once: the single north star, the late-read deployment, the dual
    north star and the priority north star at seeds 0-3 each (seed 0 the
    tracked draw), the kinds interleaved.  Every served result must equal
    the same request run alone on ``"torch"``, byte for byte; seed 0 of
    each kind must equal the C++ engine.  The phase fails unless the gang
    kernel launched with members of two or more jobs and a group spanned
    two band widths, and on any planner refusal or twin call.  One line:
    the 16-job wall beside the solo warm walls summed, batch and gang
    occupancy, the pool's counters (mixed-width groups, admits,
    exhaustion, recenters), probes refused by reason, launches by kernel.
26. replica_main: placement and replicas — a ``ReplicatedService`` of two
    replicas over ``("cuda:0",) * 4`` (each replica's ``DeviceSet`` is
    ``(cuda:0, cuda:0)``, its own dispatcher thread and pool of
    ``serve_main``'s geometry, 8 workers, a queue of 16) with a
    ``PlacementPolicy(large_read_threshold=256, mesh_shards=2)`` answers
    ``serve_main``'s 16 jobs submitted at once: the 256-read single and
    late jobs are placed on two co-resident shards (8 jobs), the dual
    (64 reads) and priority (32 chains) jobs stay on their replica's
    pool.  Every result must equal its solo unserved run on ``"torch"``
    (``serve_main``'s when it ran in the same process), seed 0 of each
    kind the C++ engine.  Fails unless 8 jobs were placed, both replicas
    routed a job, the fused sharded branch step launched with no plain
    partials, a pool launched the gang kernel with members of two or
    more jobs, no planner refusal, placement error or twin call happened,
    and every pool has its pages back after ``close()``.  Then a learned
    policy over a perf database of 3 ``arena`` and 3 slower ``mesh``
    records at bucket 256 keeps the seed-0 single job on the pool (and
    equal to its solo run).  One line: the wall beside the solo walls
    summed, jobs routed and placed per replica, launches by kernel, the
    card's name and power limit.
27. cache_main (after ``serve_main``, whose solo results it reuses): the
    consensus cache — a ``ConsensusService`` of ``serve_main``'s pool
    geometry with ``cache=True``, a temporary ``cache_dir`` and a
    snapshot every 0.25 s answers the seed-0 single, late, dual and
    priority jobs (misses, each deposited), then the same jobs with the
    reads reversed (priority in chain order) as ``CACHED`` hits with no
    kernel launch (a priority job with its chains reversed misses), the
    single job plus its consensus as a ``CERTIFIED`` hit (one exact
    scoring pass: branch-step launches), and plus a read of its truth at
    30 % error as a failed certification searched ``DONE``; a second
    service (``cache_proposals=False``, a snapshot every poll) deposits
    a bound-free snapshot of the single job's first 255 reads and
    resumes the 256-read job from it with 1 extra read; a restarted
    service on the first directory serves the reversed single job from
    its file, and searches the reversed late job whose file has a byte
    flipped (quarantined, a ``cache_quarantine`` incident).  Every
    result must equal its solo unserved run, the single ones C++ too.
    One line: each tier's status, wall and launches by kernel, the
    certify pass's ms and a ``cProfile`` of it run again, the snapshot's
    pops, the card's name and power limit.
28. procs_main (after ``serve_main``, whose solo results it reuses):
    out-of-process serving — a ``ProcFrontDoor`` of two worker processes
    (child processes running ``waffle_con_tpu_torch.serve.procs.worker``'s
    ``main`` under this script's ``_procs_worker`` wrapper, which writes each worker's launch
    counts, twin calls, planner refusals, pool counters and peak device
    memory to a file when it exits), both on the first card, 4 slots each,
    ``serve_main``'s pool geometry and a snapshot every 0.25 s, answers
    ``serve_main``'s 16 jobs submitted at once; every result, decoded from
    the wire, must equal its solo in-process run, seed 0 of each kind the
    C++ engine.  Fails unless both workers routed jobs and their counters
    show ``run_extend``, ``arena`` and the gang kernel's cross-job
    launches, with no twin call, planner refusal or failed job.  The same
    again with no snapshot (each worker's record gives the host seconds
    its searches spent taking snapshots).  Then the SIGKILL drill: 8 copies of the dual north star's seed-0 job on workers
    of one slot, a snapshot every 0.1 s; the first worker to stream a
    ``CHECKPOINT`` of a job it runs is killed; every result must equal the
    solo one, the victim must be ``lost``, a started job must have migrated
    with its checkpoint (the survivor's ``col_replay`` launches are the
    restore's activations) and exactly one ``worker_lost`` incident fire.
    Every surviving worker exits 0 and no child process is left.  One line:
    both 16-job walls beside the solo walls summed and ``serve_main``'s
    in-process wall, each worker's start (spawn to HELLO), jobs, launches
    and peak memory, the card's memory with the workers up, CHECKPOINT
    frames and bytes, the drill's detection time and migrations, the
    card's name and power limit.

The last three lines are the card's name and power limit,
the kernel table (JSON), and ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX or of ``waffle_con_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

#: the card's HBM rate (NVIDIA H100 SXM data sheet), bytes/s
PEAK_BYTES_S = 3.35e12
#: int32 lanes per SM and SMs of an H100 SXM (Hopper architecture white
#: paper: 4 partitions x 16 INT32 units per SM); the int32 peak is lanes
#: x SMs x the card's maximum SM clock, read from nvidia-smi
INT32_LANES_PER_SM = 64
SMS = 132
#: int32 operations per band cell per step: the column recurrence
#: (substitution test 2, diagonal and deletion adds 2, min 1, validity 3,
#: prefix-min 2, re-add and caps 3, column folds 3) plus the tip test 4
OPS_PER_CELL = 20


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def smi_line(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def peak_int32_ops_s() -> float:
    """int32 operations/s of the card at its maximum SM clock."""
    mhz = float(smi_line("clocks.max.sm").split()[0])
    return INT32_LANES_PER_SM * SMS * mhz * 1e6


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    int32 operations over the int32 peak."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_int32_ops_s() * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


#: arena launches of each main path's warm search (path -> count)
ARENA_LAUNCHES = {}
#: frontier-gang launches of each main path's warm search (path -> count)
GANG_LAUNCHES = {}
#: branch-step launches of each main path's warm search (path -> count)
BRANCH_LAUNCHES = {}
#: the arena calls recorded by the main paths' cold searches
ARENA_RECORDS = {}
#: each deployment's inputs, config, ``"torch"`` result (as plain data)
#: and warm wall, kept by its main phase for ``native_baseline``
BASELINE = {}


#: ``--arena off``: the engines' arena fast path switched off (the path
#: of the previous slice), for comparison runs
ARENA_OFF = False
#: ``--profile``: ``dual_main`` adds a host profile of one more warm search
PROFILE = False


def host_profile(fn, top=15):
    """``cProfile`` of ``fn()``: its wall and the ``top`` functions by
    own time as ``[function, calls, own s, cumulative s]``."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(fn)
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return dict(wall_s=round(wall, 3), top=[
        [f"{path.rsplit('/', 1)[-1]}:{line}({name})", calls, round(tt, 3),
         round(ct, 3)]
        for (path, line, name), (_cc, calls, tt, ct, _callers) in rows
    ])


def reset_arena_counts():
    """Zero the arena's, the frontier gang's and the branch step's launch
    and twin counts."""
    from waffle_con_tpu_torch.ops import arena_kernel as ak
    from waffle_con_tpu_torch.ops import branch_kernel as bk
    from waffle_con_tpu_torch.ops import ragged_kernel as rgk

    bk.branch_cuda.launches = 0
    bk.branch_cuda.entries = dict.fromkeys(bk.branch_cuda.entries, 0)
    bk.branch_cuda.fused_shards = {}
    bk.branch_cuda.fused_launches = 0
    for twin in bk.TWINS:
        twin.calls = 0
    ak.arena_cuda.launches = 0
    ak.arena_cuda.placements = {"smem": 0, "global": 0}
    ak.arena_plain.calls = 0
    rgk.run_ragged_cuda.launches = 0
    rgk.run_ragged_plain.calls = 0


def arena_plan():
    """The last arena launch's plan and the launches by band placement."""
    from waffle_con_tpu_torch.ops import arena_kernel as ak

    plan = ak.arena_cuda.last_plan
    return dict(plan=None if plan is None else plan._asdict(),
                placements=dict(ak.arena_cuda.placements))


def arena_counts():
    """(arena kernel launches, twin calls of the arena, the gang and the
    branch step) since the last reset."""
    from waffle_con_tpu_torch.ops import arena_kernel as ak
    from waffle_con_tpu_torch.ops import branch_kernel as bk
    from waffle_con_tpu_torch.ops import ragged_kernel as rgk

    return (ak.arena_cuda.launches,
            ak.arena_plain.calls + rgk.run_ragged_plain.calls
            + bk.plain_calls())


def branch_launches():
    """Branch-step kernel launches since the last reset, and by entry."""
    from waffle_con_tpu_torch.ops import branch_kernel as bk

    return bk.branch_cuda.launches, dict(bk.branch_cuda.entries)


def gang_launches():
    """Frontier-gang kernel launches since the last reset."""
    from waffle_con_tpu_torch.ops import ragged_kernel as rgk

    return rgk.run_ragged_cuda.launches


GANG_KEYS = ("gang_groups", "gang_members", "run_gang_injected",
             "run_gang_mispredict", "gang_skip_members", "gang_skip_capacity",
             "gang_skip_pending", "gang_skip_desync")


def gang_counters(c):
    """The frontier gang's counters of a search (0 where absent)."""
    return {k: c.get(k, 0) for k in GANG_KEYS}


#: the launch planners' refusals: a shape a planner refuses takes the
#: engines' host path (the arena: not engaged)
PLAN_KEYS = ("plan_refused_arena", "plan_refused_run",
             "plan_refused_run_dual", "plan_refused_ragged",
             "plan_refused_cross_card")


def plan_refusals(where, c):
    """The planners' refusal counters of a search.  Raises when any moved:
    every shape of the tracked deployments is one the kernels take, so a
    refusal there would have sent the search off the kernels."""
    got = {k: c.get(k, 0) for k in PLAN_KEYS}
    if any(got.values()):
        raise AssertionError(f"{where}: the launch planners refused "
                             f"shapes {got}")
    return got


def kernel_runs(c):
    """``run_extend`` calls that launched the run kernel: the calls minus
    those a gang deposit answered."""
    return c["run_calls"] - c.get("run_gang_injected", 0)


# ---------------------------------------------------------------------
# phase 2: kernel against plain


def _scorer(reads, **cfg):
    from waffle_con_tpu_torch import CdwfaConfigBuilder
    from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer

    b = CdwfaConfigBuilder().backend("torch").device("cuda")
    for k, v in cfg.items():
        b = getattr(b, k)(v)
    return TorchScorer(reads, b.build())


def _case_state(sc, *, prefix=b"", late=(), inactive=()):
    """Root a branch (reads in ``inactive`` left out), push ``prefix``,
    activate ``late`` reads at their offsets; returns the slot."""
    import numpy as np

    act = np.ones(sc.num_reads, dtype=bool)
    act[list(inactive)] = False
    for r, _o in late:
        act[r] = False
    h = sc.root(act)
    for k in range(len(prefix)):
        sc.push(h, prefix[: k + 1])
    for r, o in late:
        sc.activate(h, r, o, prefix)
    return h


def _copy_state(state):
    return {k: v.clone() for k, v in state.items()}


def _cut_reads(state, reads, rlen, n):
    """The first ``n`` reads of a branch store (any read count, where the
    scorer pads to a power of two): ``(state, reads, rlen)``."""
    cut = {k: (v[:, :n].contiguous() if v.dim() >= 2 and k != "cons"
               else v.clone()) for k, v in state.items()}
    return cut, reads[:n].contiguous(), rlen[:n].contiguous()


def _compare(R, A, slot, args, st_k, st_p, outs_k, outs_p):
    """Bitwise comparison of two runs' outputs and slot rows (``R`` reads,
    ``A`` symbols); returns (max_abs_err, steps, code, rec_count)."""
    import torch
    from waffle_con_tpu_torch.ops import run_kernel as rk

    rk_, rs_k, rf_k = rk.fetch(*outs_k, R, A, args.max_steps)
    rp_, rs_p, rf_p = rk.fetch(*outs_p, R, A, args.max_steps)
    err = _result_err(rk_, rp_)
    if rk_.rec_count:
        err = max(err, int(abs(rs_k - rs_p).max()), int(abs(rf_k - rf_p).max()))
    err = max(err, _rows_err(st_k, slot, st_p, slot))
    torch.cuda.synchronize()
    return err, rk_.steps, rk_.code, rk_.rec_count


def _result_err(a, b):
    """Max abs difference of two ``RunResult``s (raises on a scalar or
    shape that differs)."""
    from waffle_con_tpu_torch.ops import run_kernel as rk

    err = 0
    for name in rk.RunResult._fields:
        x, y = getattr(a, name), getattr(b, name)
        if hasattr(x, "shape"):
            if x.shape != y.shape:
                raise AssertionError(f"{name}: shape {x.shape} vs {y.shape}")
            if x.size:
                err = max(err, int(abs(x.astype("int64")
                                       - y.astype("int64")).max()))
        elif x != y:
            raise AssertionError(f"{name}: {x} vs {y}")
    return err


def _rows_err(x, i, y, j):
    """Max abs difference of branch ``i`` of ``x`` and branch ``j`` of
    ``y`` (branch stores or gang deposits): band rows, folds, length and
    the consensus up to it."""
    err = 0
    for name in ("D", "e", "rmin", "er", "clen"):
        err = max(err, int((x[name][i].long() - y[name][j].long())
                           .abs().max()))
    n = int(x["clen"][i])
    d = x["cons"][i, :n].long() - y["cons"][j, :n].long()
    return max(err, int(d.abs().max())) if d.numel() else err


def _run_args(sc, consensus_len, **kw):
    """The ``RunArgs`` of a case, as the scorer builds them for
    ``run_extend`` (unbounded budgets unless the case sets them)."""
    base = dict(me_budget=2**31 - 1, other_cost=2**31 - 1, other_len=0,
                min_count=3, l2=False, max_steps=200)
    base.update(kw)
    return sc.run_args(consensus_len, **base)


def _time_cuda(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def _truncated(make):
    """Reads cut short by 0-3 symbols: runs pass through reached ends
    (absorbed records) before the dirty stop."""
    def make2():
        truth, reads = make()
        return truth, [r[: len(r) - (k % 4)] for k, r in enumerate(reads)]
    return make2


def _one_random_read(make):
    """Read 0 replaced by random symbols: its edit distance climbs until
    the band overflows (code 5)."""
    def make2():
        import numpy as np

        truth, reads = make()
        rng = np.random.default_rng(1)
        reads = list(reads)
        reads[0] = bytes(rng.integers(0, 4, size=len(reads[0])).astype(np.uint8))
        return truth, reads
    return make2


def _cut_by_block(make, block, per):
    """Read k cut by ``per`` symbols for every ``block`` reads before it:
    each CTA's share of the reads ends at another consensus position, so
    the reached ends (records) come from one CTA after another."""
    def make2():
        truth, reads = make()
        return truth, [r[: len(r) - per * (k // block)]
                       for k, r in enumerate(reads)]
    return make2


def kernel_cases(small_only: bool):
    """(label, make-reads, scorer config, run args, state spec) cases.
    State spec keys: ``prefix_len``, ``late`` (read, offset) pairs,
    ``inactive`` reads, ``inactive_cta`` (the reads of that CTA of the
    launch plan left inactive), ``reads`` (cut the store to that many
    reads), ``force_truth``, ``engine_steps`` and ``want_code`` (the
    stop code the launch must end with, after ``max_steps`` steps)."""
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    def small(seed, err):
        return lambda: generate_test(4, 120, 10, err, seed=seed)

    cases = [
        ("small/clean", small(1, 0.0), {}, dict(max_steps=60), {}),
        ("small/err3", small(2, 0.03), {}, dict(max_steps=150), {}),
        ("small/early_term", small(3, 0.03),
         dict(allow_early_termination=True), dict(max_steps=150), {}),
        ("small/l2", small(4, 0.05), dict(allow_early_termination=True),
         dict(max_steps=120, l2=True), {}),
        ("small/forced", small(6, 0.02), {},
         dict(max_steps=40, first_sym=2), {}),
        ("small/budget", small(7, 0.0), {},
         dict(max_steps=30, me_budget=20), {}),
        ("small/records", _truncated(small(11, 0.0)), {},
         dict(max_steps=200), {}),
        ("small/overflow", _one_random_read(small(5, 0.0)), {},
         dict(max_steps=120), {}),
        ("small/offsets", small(9, 0.02), {}, dict(max_steps=100),
         dict(prefix_len=30, late=((3, 6), (7, 11)))),
        # one read: a cluster of one CTA with one warp
        ("small/one_read", small(12, 0.02), {}, dict(max_steps=100, min_count=1),
         dict(reads=1)),
        # a wide band (E=1024, W=2050): 65 cells per lane, two CTAs
        ("small/wide_band", lambda: generate_test(4, 1000, 16, 0.02, seed=13),
         dict(initial_band=1024), dict(max_steps=200), {}),
    ]
    if small_only:
        return cases
    ns = lambda: generate_test(4, 10000, 256, 0.01, seed=0)  # noqa: E731
    ns_cfg = dict(min_count=64, initial_band=216)
    for label, make, cfg, kw, state in [
        ("clean", ns, {}, dict(max_steps=300), {}),
        ("l2", ns, {}, dict(max_steps=300, l2=True), {}),
        ("early_term", ns, dict(allow_early_termination=True),
         dict(max_steps=300), {}),
        ("forced", ns, {}, dict(max_steps=300, first_sym=1), {}),
        ("budget", ns, {}, dict(max_steps=300, me_budget=100), {}),
        ("offsets", ns, {}, dict(max_steps=300),
         dict(prefix_len=60, late=((5, 4), (17, 9), (200, 13)))),
        ("overflow", _one_random_read(ns), {}, dict(max_steps=1500), {}),
        # the main path's own launch: the root pop of the north-star
        # search (forced first symbol, the engine's step bound)
        ("main_launch", ns, {}, dict(max_steps=2 * 10000 + 256),
         dict(force_truth=True)),
        # the root pop's launch under a step cap (the JAX megastep's
        # per-call budget), which must stop with code 4 exactly where
        # the plain loop does
        ("step_cap", ns, {}, dict(max_steps=100),
         dict(force_truth=True, want_code=4)),
        # north-star width (R=256, W=514) with short reads, so the run
        # reaches the read ends
        ("records", _truncated(
            lambda: generate_test(4, 400, 256, 0.01, seed=3)), {},
         dict(max_steps=600), {}),
    ]:
        cases.append((label if "/" in label else "north_star/" + label,
                      make, {**ns_cfg, **cfg}, dict(min_count=64, **kw),
                      state))
    # the cluster's edges: a read count that does not fill the CTAs, a
    # CTA whose reads are all inactive, the band after growth, the band
    # in device memory, records reached in several CTAs
    for label, make, cfg, kw, state in [
        ("reads_300", lambda: generate_test(4, 10000, 300, 0.01, seed=0),
         {}, dict(max_steps=300), dict(reads=300)),
        ("inactive_cta", ns, {}, dict(max_steps=300), dict(inactive_cta=1)),
        ("band_1026", ns, dict(initial_band=512), dict(max_steps=300), {}),
        ("global_band", lambda: generate_test(4, 2000, 1024, 0.01, seed=4),
         {}, dict(max_steps=100, min_count=256), {}),
        ("records_by_cta", _cut_by_block(
            lambda: generate_test(4, 400, 256, 0.01, seed=5), 16, 2),
         {}, dict(max_steps=600), {}),
    ]:
        cases.append(("cluster/" + label, make, {**ns_cfg, **cfg},
                      {"min_count": 64, **kw}, state))
    # the dual north star's geometry (R=64, W=258), at which the dual
    # search launches this kernel on every non-dual node
    for label, kw, state in [
        # the search's first launch: the root, no forced symbol, the
        # engine's step bound; it stops at the first SNP
        ("first_launch", {}, dict(engine_steps=True)),
        # a later launch of the search: past the first SNP, losing the
        # pop to a queued node (the search's own other_cost/other_len)
        ("lose_pop", dict(other_cost=1574, other_len=2413),
         dict(engine_steps=True, prefix_len=2365)),
        # the reads' ends: reached reads absorbed as records
        ("records", dict(max_steps=600), dict(prefix_len=4750)),
    ]:
        cases.append(("dual_north_star/" + label, _dual_north_star_h1,
                      dict(min_count=16, initial_band=116),
                      dict(min_count=16, **kw), state))
    # a priority-engine group on its level's shared store (a SubsetScorer
    # view): the reads outside the group inactive from the root, every
    # other read (rows of every CTA inactive) or the second half (whole
    # CTAs), at the priority north star's level-1 geometry (R=32, W=130;
    # both haplotypes in the interleaved group, so the run stops at the
    # first SNP) and at the dual north star's (R=64, W=258)
    odd = lambda n: range(1, n, 2)  # noqa: E731
    for label, make, cfg, kw, state in [
        ("interleaved", _priority_level1, PRIORITY_CFG, {},
         dict(engine_steps=True, inactive=odd(32))),
        ("half", _priority_level1, PRIORITY_CFG, {},
         dict(engine_steps=True, inactive=range(16, 32))),
        ("interleaved_64", _dual_north_star_h1,
         dict(min_count=16, initial_band=116), dict(max_steps=600),
         dict(inactive=odd(64))),
    ]:
        cases.append(("subset/" + label, make, cfg,
                      dict(min_count=cfg["min_count"], **kw), state))
    return cases


def _priority_level1():
    """The priority north star's level-1 reads, its first haplotype as
    truth."""
    _truth, (t1a, _t1b), chains = priority_north_star()
    return t1a, [chain[1] for chain in chains]


def _priority_level1_dual():
    """The priority north star's level-1 reads and both haplotypes."""
    _truth, (t1a, t1b), chains = priority_north_star()
    return t1a, t1b, [chain[1] for chain in chains]


def _dual_north_star_h1():
    """The dual north star's reads with its first haplotype as truth."""
    truth, _h2, reads = dual_north_star()
    return truth, reads


def phase_kernel(small_only: bool):
    """Kernel vs plain on the card.  Returns the kernel table's numbers
    (from the main path's own launch, or the first small case with
    ``small_only``), the max error over every compared output, and the
    numbers of the step-capped launch (the megastep's row; None with
    ``small_only``)."""
    from waffle_con_tpu_torch.ops import run_kernel as rk

    max_err = 0
    timing = cap_timing = None
    cache = {}
    for label, make, cfg, kw, spec in kernel_cases(small_only):
        if make not in cache:
            cache[make] = make()
        truth, reads = cache[make]
        sc = _scorer(reads, **cfg)
        prefix = truth[: spec.get("prefix_len", 0)]
        inactive = spec.get("inactive", ())
        if "inactive_cta" in spec:
            rpc = rk.plan_run(sc._R, sc._W, sc.num_symbols).reads_per_cta
            inactive = range(spec["inactive_cta"] * rpc,
                             (spec["inactive_cta"] + 1) * rpc)
        h = _case_state(sc, prefix=prefix, late=spec.get("late", ()),
                        inactive=inactive)
        slot = sc._slot_of[h]
        if spec.get("force_truth"):
            kw = dict(kw, first_sym=sc.sym_id[truth[0]])
        if spec.get("engine_steps"):
            # the engines' step bound: twice the longest read, plus 256
            kw = dict(kw, max_steps=2 * max(map(len, reads)) + 256)
        args = _run_args(sc, len(prefix), **kw)
        st0, rd, rl = sc._state, sc._reads, sc._rlen
        if "reads" in spec:
            st0, rd, rl = _cut_reads(st0, rd, rl, spec["reads"])
        R, A = rd.shape[0], sc.num_symbols
        st0 = _copy_state(st0)
        st_k, st_p = _copy_state(st0), _copy_state(st0)
        outs_k = rk.run_extend_cuda(st_k, slot, rd, rl, args)
        plan = rk.run_extend_cuda.last_plan
        # the compared plain run is also the plain version's timing
        held = []
        p_ms = _time_cuda(lambda: held.append(rk.run_extend_plain(
            st_p, slot, rd, rl, args)), 1)
        outs_p = held[0]
        err, steps, code, nrec = _compare(R, A, slot, args, st_k, st_p,
                                          outs_k, outs_p)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"{label}: kernel != plain (max err {err})")
        if "want_code" in spec and (code, steps) != (spec["want_code"],
                                                     args.max_steps):
            raise AssertionError(
                f"{label}: stopped with code {code} after {steps} steps, "
                f"want code {spec['want_code']} after {args.max_steps}")
        line = dict(case=label, reads=R, W=sc._W, steps=steps, code=code,
                    records=nrec, cluster=plan.cluster,
                    ctas_threads=plan.threads, band=plan.band)
        if not label.startswith("small/") or small_only:
            # every timed call starts from a fresh copy of the same state
            it = iter([_copy_state(st0) for _ in range(3)])
            k_ms = _time_cuda(
                lambda: rk.run_extend_cuda(next(it), slot, rd, rl, args), 3)
            per = max(steps, 1)
            # the band read and written once, each read's window read
            # once; 20 int32 operations a band cell a step
            nbytes = 2 * R * sc._W * 4 + R * (steps + sc._W) * 2
            bound_ms, bound_by = bound(nbytes,
                                       steps * R * sc._W * OPS_PER_CELL)
            line.update(kernel_ms=round(k_ms, 4), plain_ms=round(p_ms, 3),
                        kernel_us_per_step=round(1000 * k_ms / per, 3),
                        plain_us_per_step=round(1000 * p_ms / per, 2),
                        bound_ms=bound_ms, bound_by=bound_by)
            numbers = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                           bound_by=bound_by, steps=steps)
            if label == "north_star/main_launch" or (
                small_only and timing is None
            ):
                timing = numbers
            if label == "north_star/step_cap":
                cap_timing = numbers
        print("kernel", json.dumps(line), flush=True)
        del sc, st0, st_k, st_p
    return timing, max_err, cap_timing


# ---------------------------------------------------------------------
# phases 3 and 4


def phase_main():
    from waffle_con_tpu_torch import CdwfaConfigBuilder, ConsensusDWFA
    from waffle_con_tpu_torch.ops import run_kernel as rk
    from waffle_con_tpu_torch.utils.example_gen import generate_test
    import torch

    t0 = time.perf_counter()
    truth, reads = generate_test(4, 10000, 256, 0.01, seed=0)
    gen_s = time.perf_counter() - t0
    cfg = (CdwfaConfigBuilder().backend("torch").device("cuda")
           .min_count(64).initial_band(216).build())
    walls = []
    for run in ("cold", "warm"):
        eng = ConsensusDWFA(cfg)
        for r in reads:
            eng.add_sequence(r)
        rk.run_extend_cuda.launches = 0
        rk.run_extend_cuda.placements = {"smem": 0, "global": 0}
        rk.run_extend_plain.calls = 0
        reset_arena_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.consensus()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = rk.run_extend_cuda.launches
        placements = dict(rk.run_extend_cuda.placements)
        arena_launches, arena_plain = arena_counts()
        ragged_launches = gang_launches()
        branch = branch_launches()
        plain_calls = rk.run_extend_plain.calls + arena_plain
        if not res or res[0].sequence != truth:
            raise AssertionError(f"{run}: consensus != truth")
        if (arena_launches
                != eng.last_search_stats["scorer_counters"]["arena_calls"]):
            raise AssertionError(f"{run}: {arena_launches} arena launches")
        c = eng.last_search_stats["scorer_counters"]
        plan_refusals(f"main {run}", c)
        if (launches <= 0 or plain_calls != 0 or launches != kernel_runs(c)
                or ragged_launches != c.get("gang_groups", 0)):
            raise AssertionError(
                f"{run}: run kernel launches {launches}, gang launches "
                f"{ragged_launches}, plain calls {plain_calls}"
            )
    want = [(c.sequence, list(c.scores)) for c in res]
    BASELINE["single"] = dict(reads=reads, offsets=None, config=cfg,
                              want=want, torch_warm_s=walls[1])
    st = eng.last_search_stats
    c = dict(st["scorer_counters"])
    device_ms, _ = _device_ms(eng.consensus)
    line = dict(
        reads=len(reads), length=len(truth), gen_s=round(gen_s, 3),
        cold_s=round(walls[0], 3), warm_s=round(walls[1], 3),
        pops=st["nodes_explored"] + st["nodes_ignored"],
        nodes_explored=st["nodes_explored"], run_calls=c["run_calls"],
        run_steps=c["run_steps"], run_stops=_run_stops(c),
        kernel_launches=launches,
        kernel_plan=_plan_fields(rk.run_extend_cuda.last_plan),
        band_placements=placements, plain_calls=plain_calls,
        steps_per_s=round(c["run_steps"] / walls[1], 1),
        push_calls=c["push_calls"], clone_push_calls=c["clone_push_calls"],
        grow_e_events=c["grow_e_events"], scores_sum=sum(res[0].scores),
        arena_kernel_launches=arena_launches, **arena_counters(c),
        gang_kernel_launches=ragged_launches, **gang_counters(c),
        branch_step_launches=branch[0], branch_step_entries=branch[1],
        **plan_refusals("main", c),
        profiled_device_ms=device_ms,
        device_busy_share=(
            None if device_ms is None
            else round(device_ms / 1e3 / walls[1], 4)
        ),
    )
    print("main", json.dumps(line), flush=True)
    ARENA_LAUNCHES["main"] = arena_launches
    BRANCH_LAUNCHES["main"] = branch[0]
    GANG_LAUNCHES["main"] = ragged_launches
    return launches


def _run_stops(c):
    return {k: v for k, v in sorted(c.items()) if k.startswith("run_stop_")}


def _plan_fields(plan):
    """The launch geometry of a run-kernel plan, for a result line."""
    return None if plan is None else dict(
        cluster=plan.cluster, ctas_threads=plan.threads,
        reads_per_cta=plan.reads_per_cta, band=plan.band,
        smem_bytes=plan.smem_bytes)


def _device_ms(fn):
    """Device time of ``fn()``, from ``torch.profiler`` tracing the
    device only (host ops untraced, so a search of many small launches
    stays cheap to profile).  Returns the total in ms (``None`` when the
    profiler saw no device activity) and the entries as ``{name: ms}``
    (names cut to 60 characters, entries of one cut name summed),
    largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            # torch's many instantiations of one kernel template share a
            # cut name
            key = ev.key[:60]
            by_name[key] = by_name.get(key, 0.0) + us
    total = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return (round(total / 1e3, 3) if total > 0 else None,
            {name: round(us / 1e3, 3) for name, us in ranked})


def _kernel_ms(by_name, kernel):
    """Device ms of the entries of ``kernel`` (plain or templated name)."""
    return sum(ms for name, ms in by_name.items()
               if kernel + "(" in name or kernel + "<" in name)


def phase_oracle():
    from waffle_con_tpu_torch import CdwfaConfigBuilder, ConsensusDWFA
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    truth, reads = generate_test(4, 1000, 16, 0.02, seed=1)
    got = {}
    for be in ("python", "torch"):
        eng = ConsensusDWFA(
            CdwfaConfigBuilder().backend(be).device("cuda").min_count(4)
            .build()
        )
        for r in reads:
            eng.add_sequence(r)
        got[be] = [(c.sequence, c.scores) for c in eng.consensus()]
    if got["python"] != got["torch"]:
        raise AssertionError("oracle: python and torch results differ")
    print("oracle", json.dumps(dict(
        results=len(got["torch"]), truth=got["torch"][0][0] == truth,
        identical=True,
    )), flush=True)


# ---------------------------------------------------------------------
# phases 5-7: the dual engine


def dual_north_star(num_reads=64, seq_len=5000, err=0.01, seed=0):
    """The dual north star: half the reads from ``generate_test``, half
    from a second haplotype 3 SNPs away (the JAX package's ``bench.py``
    draw; ``seed`` 0 is the tracked draw, others shift every generator's
    seed).  Returns ``(truth, h2, reads)``."""
    import numpy as np
    from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

    rng = np.random.default_rng(1 + seed)
    truth, reads1 = generate_test(4, seq_len, num_reads // 2, err,
                                  seed=1 + seed)
    h2 = bytearray(truth)
    for pos in rng.choice(seq_len, size=3, replace=False):
        h2[pos] = (h2[pos] + 1 + rng.integers(3)) % 4
    h2 = bytes(h2)
    reads2 = [corrupt(h2, err,
                      np.random.default_rng(100 + num_reads * seed + i))
              for i in range(num_reads // 2)]
    return truth, h2, list(reads1) + reads2


def _small_dual(seed, err, n=6, length=140, snps=((40, 1), (90, 2))):
    """``n`` reads of one haplotype and ``n`` of a second one ``snps``
    away.  Returns ``(t1, t2, reads)``."""
    import numpy as np
    from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

    rng = np.random.default_rng(seed)
    t1, reads1 = generate_test(4, length, n, err, seed=seed)
    t2 = bytearray(t1)
    for pos, shift in snps:
        t2[pos] = (t2[pos] + shift) % 4
    return t1, bytes(t2), list(reads1) + [
        corrupt(bytes(t2), err, rng) for _ in range(n)
    ]


def _starred(make):
    """Every 20th base of every read replaced by the wildcard ``*``."""
    def make2():
        import numpy as np

        t1, t2, reads = make()
        rng = np.random.default_rng(7)
        out = []
        for r in reads:
            arr = bytearray(r)
            for pos in rng.choice(len(arr), size=len(arr) // 20,
                                  replace=False):
                arr[pos] = ord("*")
            out.append(bytes(arr))
        return t1, t2, out
    return make2


def _dual_random_read(make):
    """Read 0 replaced by random symbols (band overflow, code 5)."""
    def make2():
        import numpy as np

        t1, t2, reads = make()
        rng = np.random.default_rng(3)
        reads = list(reads)
        reads[0] = bytes(rng.integers(0, 4, size=len(reads[0])).astype(np.uint8))
        return t1, t2, reads
    return make2


def _dual_cut(make, n1, n2):
    """The first haplotype's reads cut to ``n1`` symbols, the second's to
    ``n2`` (side 1 locked at its reads' ends absorbs records)."""
    def make2():
        t1, t2, reads = make()
        half = len(reads) // 2
        return t1, t2, [r[:n1] if k < half else r[:n2]
                        for k, r in enumerate(reads)]
    return make2


def _dual_state(sc, t1, t2, spec):
    """Two branch slots for a dual case: roots (reads in ``inactive1`` /
    ``inactive2`` and the ``late`` ones inactive), each slot pushed to
    its prefix (``prefix`` symbols of t1 / t2), the late reads activated
    on slot 1, or — with ``advance`` — both slots driven from the roots
    through the scorer's own dual runs to position ``advance``, pushing
    t1's and t2's symbols at every stop.  Returns the two handles and
    the two consensus strings."""
    import numpy as np

    n = sc.num_reads
    a1 = np.ones(n, dtype=bool)
    a1[[r for r, _o in spec.get("late", ())]
       + list(spec.get("inactive1", ()))] = False
    a2 = np.ones(n, dtype=bool)
    a2[list(spec.get("inactive2", ()))] = False
    ha, hb = sc.root(a1), sc.root(a2)
    p1, p2 = spec.get("prefix", (0, 0))
    c1, c2 = t1[:p1], t2[:p2]
    for h, c in ((ha, c1), (hb, c2)):
        for k in range(len(c)):
            sc.push(h, c[: k + 1])
    for r, o in spec.get("late", ()):
        sc.activate(ha, r, o, c1)
    target = spec.get("advance", 0)
    while len(c1) < target:
        steps, code, app1, app2 = sc.run_extend_dual(
            ha, hb, c1, c2, 2**31 - 1, 2**31 - 1, 0, spec["min_count"],
            20, 2, False, False, target - len(c1),
        )[:4]
        c1, c2 = c1 + app1, c2 + app2
        if code not in (1, 4, 5):
            raise AssertionError(f"advance: unexpected stop code {code}")
        if code == 1:
            c1, c2 = c1 + t1[len(c1):len(c1) + 1], c2 + t2[len(c2):len(c2) + 1]
            sc.push(ha, c1)
            sc.push(hb, c2)
    return ha, hb, c1, c2


def _dual_args(sc, c1, c2, kw):
    """``(DualRunArgs, mc_tab, imb_tab)`` of a case, as the scorer builds
    them for ``run_extend_dual`` (unbounded budgets unless the case sets
    them)."""
    base = dict(me_budget=2**31 - 1, other_cost=2**31 - 1, other_len=0,
                ed_delta=20, imb_min=2, l2=False, weighted=False,
                max_steps=200)
    base.update(kw)
    return sc.dual_run_args(max(len(c1), len(c2)), **base)


def _dual_compare(R, A, slots, args, st_k, st_p, outs_k, outs_p):
    """Bitwise comparison of two dual runs' packed outputs, records and
    both slots' rows (``R`` reads, ``A`` symbols); returns (max_abs_err,
    steps, code, rec_count)."""
    import torch
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk

    a_out, b_out = outs_k[0].cpu(), outs_p[0].cpu()
    err = int((a_out.long() - b_out.long()).abs().max())
    res, rs_k, rf_k = rdk.fetch(*outs_k, R, A, args.max_steps)
    _res_p, rs_p, rf_p = rdk.fetch(*outs_p, R, A, args.max_steps)
    if res.rec_count:
        err = max(err, int(abs(rs_k - rs_p).max()), int(abs(rf_k - rf_p).max()))
    for slot in slots:
        clen = int(st_k["clen"][slot])
        for name in ("D", "e", "rmin", "er", "act", "clen"):
            d = (st_k[name][slot].long() - st_p[name][slot].long()).abs().max()
            err = max(err, int(d))
        d = st_k["cons"][slot, :clen].long() - st_p["cons"][slot, :clen].long()
        if d.numel():
            err = max(err, int(d.abs().max()))
    torch.cuda.synchronize()
    return err, res.steps, res.code, res.rec_count


def _same_haplotype(make):
    """Reads of one haplotype as both sides' truth: ``(t, t, reads)``."""
    def make2():
        truth, reads = make()
        return truth, truth, list(reads)
    return make2


def dual_kernel_cases(small_only: bool):
    """(label, make-reads, scorer config, run args, state spec) cases.
    State spec keys: those of :func:`_dual_state`, ``reads`` (cut the
    store to that many reads) and ``inactive2_cta`` (the reads of that
    CTA of the launch plan left inactive on side 2)."""
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    split = dict(prefix=(45, 45))
    cases = [
        ("small/from_root", lambda: _small_dual(41, 0.0), {},
         dict(max_steps=120), {}),
        ("small/split", lambda: _small_dual(42, 0.02), {},
         dict(max_steps=120), split),
        ("small/err3", lambda: _small_dual(43, 0.03), {},
         dict(max_steps=120), split),
        ("small/early_term", lambda: _small_dual(44, 0.02),
         dict(allow_early_termination=True), dict(max_steps=120), split),
        ("small/l2", lambda: _small_dual(45, 0.03), {},
         dict(max_steps=120, l2=True, ed_delta=2), split),
        ("small/weighted", lambda: _small_dual(46, 0.02), {},
         dict(max_steps=120, weighted=True), split),
        ("small/lock1", lambda: _small_dual(47, 0.02), {},
         dict(max_steps=80, lock1=True), dict(prefix=(8, 12))),
        ("small/lock2", lambda: _small_dual(48, 0.02), {},
         dict(max_steps=80, lock2=True), dict(prefix=(12, 8))),
        ("small/ed_delta", lambda: _small_dual(49, 0.0), {},
         dict(max_steps=150, ed_delta=0), split),
        ("small/imbalance", lambda: _small_dual(50, 0.0), {},
         dict(max_steps=150, ed_delta=0, imb_min=7), split),
        ("small/budget", lambda: _small_dual(51, 0.03), {},
         dict(max_steps=100, me_budget=15), split),
        ("small/step_cap", lambda: _small_dual(52, 0.0), {},
         dict(max_steps=10), split),
        ("small/overflow", _dual_random_read(lambda: _small_dual(53, 0.0)),
         {}, dict(max_steps=120, ed_delta=200), {}),
        ("small/records", _dual_cut(lambda: _small_dual(54, 0.0), 100, 106),
         {}, dict(max_steps=200, lock1=True),
         dict(prefix=(100, 100), inactive1=range(6, 12),
              inactive2=range(6))),
        ("small/mc_dyn", lambda: _small_dual(55, 0.01), {},
         dict(max_steps=120, mc_dyn=True, rec_min=4,
              mc_tab=[2] * 9 + [3] * 4, imb_tab=[2, 2, 3, 3, 3, 4]), {}),
        ("small/offsets", lambda: _small_dual(56, 0.02), {},
         dict(max_steps=100), dict(prefix=(30, 30), late=((3, 6), (8, 11)))),
        ("small/wildcard", _starred(lambda: _small_dual(57, 0.02)),
         dict(wildcard=ord("*")), dict(max_steps=120), split),
        # one read: a cluster of one CTA, one warp pair
        ("small/one_read", lambda: _small_dual(58, 0.02), {},
         dict(max_steps=100, min_count=1, imb_min=1), dict(reads=1)),
    ]
    cases = [(lb, mk, cfg, {"min_count": 3, **kw}, {"min_count": 3, **st})
             for lb, mk, cfg, kw, st in cases]
    if small_only:
        return cases
    ns = dual_north_star
    ns_cfg = dict(min_count=16, initial_band=116)
    long_steps = 2 * 5000 + 256
    for label, make, cfg, kw, spec in [
        # both slots from the roots: identical sides up to the first SNP
        ("from_root", ns, {}, dict(max_steps=long_steps), {}),
        ("l2", ns, {}, dict(max_steps=300, l2=True), {}),
        ("weighted", ns, {}, dict(max_steps=300, weighted=True), {}),
        ("early_term", ns, dict(allow_early_termination=True),
         dict(max_steps=300), {}),
        ("offsets", ns, {}, dict(max_steps=300),
         dict(prefix=(60, 60), late=((5, 4), (17, 9), (40, 13)))),
        ("overflow", _dual_random_read(ns), {}, dict(max_steps=1500), {}),
        # a long launch at the search's geometry, made for timing (the
        # search's own dual launches are short: dual_main's profile
        # gives their mean): split sides, from just past the second SNP
        # (and the ambiguous columns right after it) to the third
        ("long_launch", ns, {}, dict(max_steps=long_steps),
         dict(advance=2570)),
        # the same state, two steps: the fixed cost of a launch (the
        # search's own launches commit about two steps each)
        ("short_launch", ns, {}, dict(max_steps=2), dict(advance=2570)),
        # split sides, side 2 locked (its rows on chip, frozen)
        ("lock2", ns, {}, dict(max_steps=300, lock2=True),
         dict(advance=2570)),
        # split sides, weighted votes: non-dyadic weights from every CTA
        ("weighted_split", ns, {}, dict(max_steps=300, weighted=True),
         dict(advance=2570)),
    ]:
        cases.append(("north_star/" + label, make, {**ns_cfg, **cfg},
                      dict(min_count=16, **kw), dict(min_count=16, **spec)))
    # the cluster's edges at the dual north star's geometry (8 CTAs of 8
    # reads): a read count that does not fill the CTAs, a CTA whose reads
    # are inactive on one side, pruning in the CTAs of the second
    # haplotype's reads (ranks 4-7: ed_delta 0 just past the first SNP),
    # records (a locked side whose reads ended CTA by CTA, at 2 symbols
    # a CTA, while the other side runs to its reads' ends); and 256 reads
    # at W=1026, the band in device memory
    for label, make, cfg, kw, spec in [
        ("reads_60", ns, {}, dict(max_steps=300),
         dict(advance=2570, reads=60)),
        ("inactive_cta", ns, {}, dict(max_steps=300),
         dict(inactive2_cta=1)),
        ("prune", ns, {}, dict(max_steps=300, ed_delta=0),
         dict(advance=2400)),
        ("records_by_cta", _same_haplotype(_cut_by_block(
            lambda: generate_test(4, 400, 64, 0.01, seed=5), 8, 2)),
         {}, dict(max_steps=600, lock1=True), dict(prefix=(400, 300))),
        ("global_band", lambda: dual_north_star(256, 2000),
         dict(initial_band=512), dict(max_steps=200), {}),
    ]:
        cases.append(("cluster/" + label, make, {**ns_cfg, **cfg},
                      dict(min_count=16, **kw), dict(min_count=16, **spec)))
    # plan_gate's dual draw (256 reads over 256 symbols): 16 warps' tip
    # histograms and partials overflow a CTA, so the plan halves the warps
    # (8 a CTA, both sides of two reads a warp), the band in device memory
    # at W=234 and on chip at W=66; split sides past the first SNP
    wide = lambda: _alphabet_draw(  # noqa: E731
        256, 256, 320, 0.01, 5, snps=((110, 1), (220, 7)))
    for label, band in [("wide_alphabet", 116), ("wide_alphabet_smem", 32)]:
        cases.append(("cluster/" + label, wide,
                      dict(min_count=32, initial_band=band),
                      dict(min_count=32, max_steps=300),
                      dict(min_count=32, prefix=(115, 115))))
    # a priority-engine group on its level's shared store: every other
    # read inactive from the root in both slots, split sides driven past
    # the first SNP, at the priority north star's level-1 geometry (R=32,
    # W=130; its SNPs at 666 and 1333) and at the dual north star's
    for label, make, cfg, spec in [
        ("interleaved", _priority_level1_dual, PRIORITY_CFG,
         dict(advance=700, inactive1=range(1, 32, 2),
              inactive2=range(1, 32, 2))),
        ("interleaved_64", ns, ns_cfg,
         dict(advance=2570, inactive1=range(1, 64, 2),
              inactive2=range(1, 64, 2))),
    ]:
        mc = dict(min_count=cfg["min_count"])
        cases.append(("subset/" + label, make, cfg,
                      dict(max_steps=600, **mc), dict(spec, **mc)))
    return cases


def phase_dual_kernel(small_only: bool):
    """Dual kernel vs plain on the card.  Returns the kernel table's
    numbers (from the long launch at the north-star geometry, or the
    first small case with ``small_only``) and the max error over every
    compared output."""
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk

    max_err = 0
    timing = None
    cache = {}
    for label, make, cfg, kw, spec in dual_kernel_cases(small_only):
        if make not in cache:
            cache[make] = make()
        t1, t2, reads = cache[make]
        sc = _scorer(reads, **cfg)
        if "inactive2_cta" in spec:
            k = spec["inactive2_cta"]
            rpc = rdk.plan_run_dual(sc._R, sc._W,
                                    sc.num_symbols).reads_per_cta
            spec = dict(spec, inactive2=range(k * rpc, (k + 1) * rpc))
        ha, hb, c1, c2 = _dual_state(sc, t1, t2, spec)
        slots = (sc._slot_of[ha], sc._slot_of[hb])
        args, mc, imb = _dual_args(sc, c1, c2, kw)
        st0, rd, rl = sc._state, sc._reads, sc._rlen
        if "reads" in spec:
            st0, rd, rl = _cut_reads(st0, rd, rl, spec["reads"])
        R, A = rd.shape[0], sc.num_symbols
        st0 = _copy_state(st0)
        st_k, st_p = _copy_state(st0), _copy_state(st0)
        call = lambda fn, st: fn(  # noqa: E731
            st, slots[0], slots[1], rd, rl, mc, imb, args)
        outs_k = call(rdk.run_extend_dual_cuda, st_k)
        plan = rdk.run_extend_dual_cuda.last_plan
        held = []
        p_ms = _time_cuda(lambda: held.append(
            call(rdk.run_extend_dual_plain, st_p)), 1)
        err, steps, code, nrec = _dual_compare(R, A, slots, args, st_k, st_p,
                                               outs_k, held[0])
        if label.startswith("cluster/wide_alphabet") and (
                plan.threads != 256 or plan.band != (
                    "smem" if label.endswith("_smem") else "global")):
            raise AssertionError(f"{label}: plan {plan}, want 8 warps")
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"{label}: dual kernel != plain (max err {err})")
        line = dict(case=label, reads=R, W=sc._W, steps=steps, code=code,
                    records=nrec, plan=_dual_plan_fields(plan))
        if not label.startswith("small/") or small_only:
            it = iter([_copy_state(st0) for _ in range(3)])
            k_ms = _time_cuda(
                lambda: call(rdk.run_extend_dual_cuda, next(it)), 3)
            per = max(steps, 1)
            line.update(kernel_ms=round(k_ms, 4), plain_ms=round(p_ms, 3),
                        kernel_us_per_step=round(1000 * k_ms / per, 3),
                        plain_us_per_step=round(1000 * p_ms / per, 2))
            if label == "north_star/short_launch":
                # the fixed cost of a launch on the device alone (the
                # events above also hold the wrapper's host time)
                it = iter([_copy_state(st0) for _ in range(20)])
                _, by_name = _device_ms(lambda: [
                    call(rdk.run_extend_dual_cuda, next(it))
                    for _ in range(20)])
                line["kernel_device_ms"] = round(
                    _kernel_ms(by_name, "run_extend_dual_kernel") / 20, 4)
            if label == "north_star/long_launch" or (
                small_only and timing is None
            ):
                act = [int(st0["act"][sl].sum()) for sl in slots]
                unlocked = [not args.lock1, not args.lock2]
                bound_ms, bound_by = dual_bound(
                    R, sc._W, steps,
                    sum(a for a, u in zip(act, unlocked) if u))
                timing = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                              bound_by=bound_by, steps=steps)
        print("dual_kernel", json.dumps(line), flush=True)
        del sc, st0, st_k, st_p
    return timing, max_err


def dual_bound(R, W, steps, rows):
    """(bound_ms, bound_by) of a dual launch of ``steps`` steps: each
    side's band read and written once and its read windows read once;
    int32 work on ``rows`` stepped (side, read) rows."""
    nbytes = 2 * (2 * R * W * 4 + R * (steps + W) * 2)
    return bound(nbytes, steps * W * OPS_PER_CELL * rows)


def _dual_plan_fields(plan):
    """The launch geometry of a dual-kernel plan, for a result line."""
    return None if plan is None else dict(
        cluster=plan.cluster, ctas_threads=plan.threads,
        rows_per_cta=2 * plan.reads_per_cta,
        rows_per_warp=plan.rows_per_warp, band=plan.band,
        smem_bytes=plan.smem_bytes)


def _dual_key(results):
    cons = lambda c: None if c is None else (c.sequence, list(c.scores))  # noqa: E731
    return [(cons(d.consensus1), cons(d.consensus2), list(d.is_consensus1),
             list(d.scores1), list(d.scores2)) for d in results]


class _NoSpeculator:
    """Stands in for the engines' ``FrontierSpeculator`` when timing the
    speculation layer: never gangs, does no per-pop work."""

    def __init__(self, scorer, config=None):
        pass

    def width(self, queue_depth, gap):
        return 1

    def pending(self, h):
        return False


def speculator_cost(module, make_engine, reads, reps=3):
    """Host cost of the engines' speculation layer: warm searches with the
    module's ``FrontierSpeculator`` and with :class:`_NoSpeculator` in its
    place, alternating (with, without, ...).  Returns each
    one's walls, the pops (the same search either way) and the
    difference of the minima in µs a pop."""
    import torch

    real = module.FrontierSpeculator
    walls = {"with": [], "without": []}
    pops, keys = None, set()
    try:
        for k in range(2 * reps):
            which = ("with", "without")[k % 2]
            module.FrontierSpeculator = real if which == "with" else (
                _NoSpeculator)
            eng = make_engine()
            for r in reads:
                eng.add_sequence(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.consensus()
            torch.cuda.synchronize()
            walls[which].append(round(time.perf_counter() - t0, 4))
            st = eng.last_search_stats
            pops = st["nodes_explored"] + st["nodes_ignored"]
            keys.add(repr(_dual_key(res)))
    finally:
        module.FrontierSpeculator = real
    if len(keys) != 1:
        raise AssertionError("speculator_cost: results differ with and "
                             "without the speculator")
    return dict(
        pops=pops, with_s=walls["with"], without_s=walls["without"],
        us_per_pop=round(
            1e6 * (min(walls["with"]) - min(walls["without"])) / pops, 3))


def phase_dual_main():
    from waffle_con_tpu_torch import CdwfaConfigBuilder, DualConsensusDWFA
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
    from waffle_con_tpu_torch.ops import run_kernel as rk
    import torch

    t0 = time.perf_counter()
    truth, h2, reads = dual_north_star()
    gen_s = time.perf_counter() - t0
    cfg = (CdwfaConfigBuilder().backend("torch").device("cuda")
           .min_count(16).initial_band(116).build())
    walls = []
    recorder = ArenaRecorder(3)
    for run in ("cold", "warm"):
        eng = DualConsensusDWFA(cfg)
        for r in reads:
            eng.add_sequence(r)
        reset_arena_counts()
        rdk.run_extend_dual_cuda.launches = 0
        rdk.run_extend_dual_cuda.placements = {"smem": 0, "global": 0}
        rdk.run_extend_dual_plain.calls = 0
        rk.run_extend_cuda.launches = 0
        rk.run_extend_cuda.placements = {"smem": 0, "global": 0}
        rk.run_extend_plain.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "cold":
            with recorder:
                res = eng.consensus()
        else:
            res = eng.consensus()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = (rdk.run_extend_dual_cuda.launches,
                    rk.run_extend_cuda.launches) + arena_counts()[:1]
        ragged_launches = gang_launches()
        branch = branch_launches()
        placements = dict(rk.run_extend_cuda.placements)
        dual_placements = dict(rdk.run_extend_dual_cuda.placements)
        plain_calls = (rdk.run_extend_dual_plain.calls,
                       rk.run_extend_plain.calls) + arena_counts()[1:]
        if not res or not res[0].is_dual() or {
            res[0].consensus1.sequence, res[0].consensus2.sequence
        } != {truth, h2}:
            raise AssertionError(f"{run}: haplotypes not recovered")
        # the path runs the single kernel up to the split and the arena
        # after it (the dual kernel where a dual node has no competitor);
        # no plain twin runs
        c = eng.last_search_stats["scorer_counters"]
        plan_refusals(f"dual_main {run}", c)
        if (launches[1] <= 0 or plain_calls != (0, 0, 0)
                or launches != (c["run_dual_calls"], kernel_runs(c),
                                c.get("arena_calls", 0))
                or ragged_launches != c.get("gang_groups", 0)
                or (launches[2] <= 0 and not ARENA_OFF)):
            raise AssertionError(
                f"{run}: kernel launches (dual, single, arena) {launches}, "
                f"plain calls {plain_calls}"
            )
    device_ms, by_name = _device_ms(eng.consensus)
    # the profiled search is the same deterministic search: same launches
    per_launch = {
        key: None if not n else round(_kernel_ms(by_name, kernel) / n, 4)
        for key, kernel, n in (
            ("dual_kernel_device_ms_per_launch", "run_extend_dual_kernel",
             launches[0]),
            ("run_kernel_device_ms_per_launch", "run_extend_kernel",
             launches[1]),
            ("arena_kernel_device_ms_per_launch", "arena_kernel",
             launches[2]),
        )
    }
    profile = host_profile(eng.consensus) if PROFILE else None
    st = eng.last_search_stats
    c = st["scorer_counters"]
    steps = c["run_dual_steps"] + c["run_steps"]
    from waffle_con_tpu_torch.models import dual_consensus as dc
    spec_cost = speculator_cost(dc, lambda: DualConsensusDWFA(cfg), reads)
    # the least time of the search's mean dual launch (its band width as
    # the scorer starts it; every row of both sides stepped)
    W = _scorer(reads, min_count=16, initial_band=116)._W
    mean_steps = c["run_dual_steps"] / max(c["run_dual_calls"], 1)
    mean_bound_ms, mean_bound_by = dual_bound(
        len(reads), W, mean_steps, 2 * len(reads))
    line = dict(
        reads=len(reads), length=len(truth), gen_s=round(gen_s, 3),
        cold_s=round(walls[0], 3), warm_s=round(walls[1], 3),
        pops=st["nodes_explored"] + st["nodes_ignored"],
        nodes_explored=st["nodes_explored"],
        run_dual_calls=c["run_dual_calls"], run_dual_steps=c["run_dual_steps"],
        run_calls=c["run_calls"], run_steps=c["run_steps"],
        dual_kernel_launches=launches[0], run_kernel_launches=launches[1],
        arena_kernel_launches=launches[2], arena_kernel_plan=arena_plan(),
        **arena_counters(c),
        gang_kernel_launches=ragged_launches, **gang_counters(c),
        **plan_refusals("dual_main", c),
        dual_kernel_plan=_dual_plan_fields(rdk.run_extend_dual_cuda.last_plan),
        dual_kernel_band_placements=dual_placements,
        run_kernel_plan=_plan_fields(rk.run_extend_cuda.last_plan),
        run_kernel_band_placements=placements,
        plain_calls=list(plain_calls),
        steps_per_s=round(steps / walls[1], 1),
        push_calls=c["push_calls"], clone_push_calls=c["clone_push_calls"],
        activate_calls=c["activate_calls"], grow_e_events=c["grow_e_events"],
        scores_sum=sum(res[0].consensus1.scores) + sum(res[0].consensus2.scores),
        profiled_device_ms=device_ms,
        top_device_ms=dict(list(by_name.items())[:6]), **per_launch,
        dual_steps_per_launch=round(mean_steps, 4),
        dual_kernel_bound_ms_per_launch=mean_bound_ms,
        dual_kernel_bound_by=mean_bound_by,
        device_busy_share=(
            None if device_ms is None
            else round(device_ms / 1e3 / walls[1], 4)
        ),
        host_ms_per_pop=round(
            (walls[1] - (device_ms or 0) / 1e3) * 1e3
            / max(st["nodes_explored"] + st["nodes_ignored"], 1), 4),
        speculator_cost=spec_cost,
        host_profile=profile,
    )
    print("dual_main", json.dumps(line), flush=True)
    BASELINE["dual"] = dict(reads=reads, config=cfg, want=_dual_key(res),
                            torch_warm_s=walls[1])
    ARENA_LAUNCHES["dual_main"] = launches[2]
    BRANCH_LAUNCHES["dual_main"] = branch[0]
    GANG_LAUNCHES["dual_main"] = ragged_launches
    ARENA_RECORDS["dual_main"] = recorder.calls
    return launches


def phase_dual_oracle():
    from waffle_con_tpu_torch import CdwfaConfigBuilder, DualConsensusDWFA

    t1, t2, reads = _small_dual(61, 0.02, n=8, length=1000,
                                snps=((300, 1), (700, 2)))
    got = {}
    for be in ("python", "torch"):
        eng = DualConsensusDWFA(
            CdwfaConfigBuilder().backend(be).device("cuda").min_count(4)
            .build()
        )
        for r in reads:
            eng.add_sequence(r)
        got[be] = _dual_key(eng.consensus())
    if got["python"] != got["torch"]:
        raise AssertionError("dual_oracle: python and torch results differ")
    first = got["torch"][0]
    print("dual_oracle", json.dumps(dict(
        results=len(got["torch"]), dual=first[1] is not None,
        truth={first[0][0], None if first[1] is None else first[1][0]}
        == {t1, t2},
        identical=True,
    )), flush=True)


# ---------------------------------------------------------------------
# phases 8-9: the priority engine


#: the priority north star's engine settings: ``bench.py``'s
#: ``bench_priority`` at its defaults (``min_count`` a quarter of the 32
#: chains; ``initial_band`` its band seed for 2 kb at 1 %: E=64, W=130)
PRIORITY_CFG = dict(min_count=8, initial_band=56)


def priority_north_star():
    """The priority north star: 32 two-level chains, level 0 of 1 kb
    reads of one truth, level 1 of 2 kb reads of two haplotypes two SNPs
    apart (16 chains each).  Returns ``(truth, (t1a, t1b), chains)``."""
    from waffle_con_tpu_torch.utils.example_gen import generate_priority_test

    return generate_priority_test(32, 2000, 0.01)


def _priority_key(res):
    return ([[(c.sequence, list(c.scores)) for c in chain]
             for chain in res.consensuses], list(res.sequence_indices))


def phase_priority_main():
    """The priority north star through ``PriorityConsensusDWFA`` on
    ``cuda``, cold and warm.  Returns the launches of (run_extend,
    run_extend_dual) in the warm search."""
    import weakref

    from waffle_con_tpu_torch import CdwfaConfigBuilder, PriorityConsensusDWFA
    from waffle_con_tpu_torch.models import priority_consensus as pc
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
    from waffle_con_tpu_torch.ops import run_kernel as rk
    import torch

    t0 = time.perf_counter()
    truth, (t1a, t1b), chains = priority_north_star()
    gen_s = time.perf_counter() - t0
    want_seqs = [[truth, min(t1a, t1b)], [truth, max(t1a, t1b)]]
    first = 0 if t1a < t1b else 1
    want_idx = [first] * 16 + [1 - first] * 16
    b = CdwfaConfigBuilder().backend("torch").device("cuda")
    for k, v in PRIORITY_CFG.items():
        b = getattr(b, k)(v)
    cfg = b.build()

    # each level's shared scorer, seen as it is built (geometry) and
    # after the search (a weak reference: eviction must have freed it)
    built = []
    make = pc.make_scorer

    def recording(reads, config):
        sc = make(reads, config)
        built.append(dict(length=max(map(len, reads)), R=sc._R, W=sc._W,
                          A=sc.num_symbols, ref=weakref.ref(sc)))
        return sc

    walls = []
    recorder = ArenaRecorder(1)
    pc.make_scorer = recording
    try:
        for run in ("cold", "warm"):
            eng = PriorityConsensusDWFA(cfg)
            for chain in chains:
                eng.add_sequence_chain(chain)
            del built[:]
            torch.cuda.synchronize()
            mem_before = torch.cuda.memory_allocated()
            rk.run_extend_cuda.launches = 0
            rk.run_extend_plain.calls = 0
            rdk.run_extend_dual_cuda.launches = 0
            rdk.run_extend_dual_plain.calls = 0
            reset_arena_counts()
            t0 = time.perf_counter()
            if run == "cold":
                with recorder:
                    res = eng.consensus()
            else:
                res = eng.consensus()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = (rk.run_extend_cuda.launches,
                        rdk.run_extend_dual_cuda.launches) + arena_counts()[:1]
            ragged_launches = gang_launches()
            branch = branch_launches()
            plain_calls = (rk.run_extend_plain.calls,
                           rdk.run_extend_dual_plain.calls) + arena_counts()[1:]
            st = eng.last_search_stats
            c = st["scorer_counters"]
            got = _priority_key(res)
            if [[s for s, _ in chain] for chain in got[0]] != want_seqs:
                raise AssertionError(f"{run}: consensus chains != truth")
            if got[1] != want_idx:
                raise AssertionError(f"{run}: read groups {got[1]}")
            if st["scorer_constructions"] != 2:
                raise AssertionError(
                    f"{run}: {st['scorer_constructions']} scorers built")
            plan_refusals(f"priority_main {run}", c)
            counted = (kernel_runs(c), c["run_dual_calls"],
                       c.get("arena_calls", 0))
            if (launches[0] <= 0 or plain_calls != (0, 0, 0)
                    or launches != counted
                    or ragged_launches != c.get("gang_groups", 0)
                    or (launches[2] <= 0 and not ARENA_OFF)):
                raise AssertionError(
                    f"{run}: kernel launches (run, dual, arena) {launches}, "
                    f"counted {counted}, plain calls {plain_calls}")
            alive = [lv for lv in built if lv["ref"]() is not None]
            if alive:
                raise AssertionError(f"{run}: {len(alive)} level scorers "
                                     "still alive after the search")
            mem_after = torch.cuda.memory_allocated()
    finally:
        pc.make_scorer = make
    device_ms, by_name = _device_ms(eng.consensus)
    groups = [
        dict(level=g["level"], reads=g["size"], dual=g["dual"],
             pops=g["nodes_explored"] + g["nodes_ignored"],
             run_launches=g["scorer_counters"]["run_calls"],
             run_steps=g["scorer_counters"]["run_steps"],
             dual_launches=g["scorer_counters"]["run_dual_calls"],
             dual_steps=g["scorer_counters"]["run_dual_steps"],
             arena_launches=g["scorer_counters"].get("arena_calls", 0),
             arena_steps=g["scorer_counters"].get("arena_steps", 0),
             grow_e_events=g["scorer_counters"]["grow_e_events"],
             live_handles=g["live_handles"])
        for g in st["groups"]
    ]
    levels = [
        dict(read_length=lv["length"], R=lv["R"], W=lv["W"],
             run_plan=_plan_fields(rk.plan_run(lv["R"], lv["W"], lv["A"])),
             dual_plan=_dual_plan_fields(
                 rdk.plan_run_dual(lv["R"], lv["W"], lv["A"])))
        for lv in built
    ]
    line = dict(
        chains=len(chains), lengths=[len(truth), len(t1a)],
        gen_s=round(gen_s, 3), cold_s=round(walls[0], 3),
        warm_s=round(walls[1], 3), groups_solved=len(groups),
        scorer_constructions=st["scorer_constructions"],
        pops=st["nodes_explored"] + st["nodes_ignored"],
        run_launches=launches[0], run_steps=c["run_steps"],
        dual_launches=launches[1], dual_steps=c["run_dual_steps"],
        arena_launches=launches[2], arena_kernel_plan=arena_plan(),
        **arena_counters(c),
        gang_kernel_launches=ragged_launches, **gang_counters(c),
        **plan_refusals("priority_main", c),
        plain_calls=list(plain_calls), grow_e_events=c["grow_e_events"],
        groups=groups, levels=levels,
        live_handles=[g["live_handles"] for g in groups],
        device_mem_before_after=[mem_before, mem_after],
        profiled_device_ms=device_ms,
        run_kernel_device_ms=round(_kernel_ms(by_name, "run_extend_kernel"), 3),
        dual_kernel_device_ms=round(
            _kernel_ms(by_name, "run_extend_dual_kernel"), 3),
        arena_kernel_device_ms=round(_kernel_ms(by_name, "arena_kernel"), 3),
        top_device_ms=dict(list(by_name.items())[:6]),
        device_busy_share=(
            None if device_ms is None
            else round(device_ms / 1e3 / walls[1], 4)
        ),
    )
    print("priority_main", json.dumps(line), flush=True)
    BASELINE["priority"] = dict(chains=chains, config=cfg, want=got,
                                torch_warm_s=walls[1])
    ARENA_LAUNCHES["priority_main"] = launches[2]
    BRANCH_LAUNCHES["priority_main"] = branch[0]
    GANG_LAUNCHES["priority_main"] = ragged_launches
    ARENA_RECORDS["priority_main"] = recorder.calls
    return launches


def phase_priority_oracle():
    """Every fixture and two generated draws (16 chains x 1 kb at 2 %):
    the ``"python"`` oracle and ``"torch"`` on ``cuda`` give equal
    ``PriorityConsensus`` results, scores included."""
    from waffle_con_tpu_torch import (
        CdwfaConfigBuilder,
        ConsensusCost,
        PriorityConsensusDWFA,
    )
    from waffle_con_tpu_torch.utils.example_gen import generate_priority_test
    from waffle_con_tpu_torch.utils.fixtures import (
        PRIORITY_SCENARIOS,
        load_priority_fixture,
    )

    cases = []
    for name, include, fields in PRIORITY_SCENARIOS:
        fields = dict(fields, wildcard=ord("*"))
        chains, _ = load_priority_fixture(
            name, include,
            fields.get("consensus_cost", ConsensusCost.L1_DISTANCE))
        cases.append((name, chains, fields))
    for seeds in ((5, 6, 300), (7, 8, 400)):
        _truth, _hap, chains = generate_priority_test(16, 1000, 0.02, seeds)
        cases.append((f"draw_{seeds[0]}", chains,
                      dict(min_count=4, initial_band=56)))
    seen = {}
    for name, chains, fields in cases:
        got = {}
        for be in ("python", "torch"):
            b = CdwfaConfigBuilder().backend(be).device("cuda")
            for k, v in fields.items():
                b = getattr(b, k)(v)
            eng = PriorityConsensusDWFA(b.build())
            for chain in chains:
                eng.add_sequence_chain(chain)
            t0 = time.perf_counter()
            got[be] = _priority_key(eng.consensus())
            got[be + "_s"] = round(time.perf_counter() - t0, 3)
        if got["python"] != got["torch"]:
            raise AssertionError(f"priority_oracle: {name}: python and torch "
                                 "results differ")
        seen[name] = dict(groups=len(got["torch"][0]),
                          python_s=got["python_s"], torch_s=got["torch_s"])
    print("priority_oracle", json.dumps(dict(cases=seen, identical=True)),
          flush=True)


# ---------------------------------------------------------------------
# phases 10-12: late reads and band growth

#: int32 operations per 64-bit word per column of the offset scan's bit
#: vectors: its dozen 64-bit bitwise operations and one add (two int32
#: operations each), the score's update and the shifts' carries
SCAN_OPS_PER_WORD = 32

#: the late-read deployment's engine settings: the single north star's
#: reads and min_count, no initial_band (the band starts at E=8 and
#: grows), the default offset_window and offset_compare_length of 50
LATE_CFG = dict(min_count=64)


def _cut_late(reads, cut, seed=7):
    """Every read ``i % 4 == 3`` cut at a start drawn from
    ``default_rng(seed).integers(*cut)`` in read order: ``[(read,
    offset or None), ...]``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i, r in enumerate(reads):
        if i % 4 == 3:
            s = int(rng.integers(*cut))
            out.append((r[s:], s))
        else:
            out.append((r, None))
    return out


def late_draw(num_reads=256, seq_len=10000, err=0.01, cut=(1000, 5000),
              seed=0):
    """``generate_test(4, seq_len, num_reads, err, seed=seed)`` with every
    read ``i % 4 == 3`` cut as :func:`_cut_late` does.  Returns
    ``(truth, [(read, offset or None), ...])``."""
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    truth, reads = generate_test(4, seq_len, num_reads, err, seed=seed)
    return truth, _cut_late(reads, cut)


def late_dual_draw(n=8, length=1000, err=0.02, cut=(100, 500)):
    """``n`` reads of one haplotype and ``n`` of a second one 2 SNPs away
    (``_small_dual``), every read ``i % 4 == 3`` of each haplotype cut as
    in :func:`late_draw`.  Returns ``(t1, t2, [(read, offset), ...])``."""
    t1, t2, reads = _small_dual(62, err, n=n, length=length,
                                snps=((300, 1), (700, 2)))
    return t1, t2, _cut_late(reads, cut)


def _add_reads(eng, reads):
    for r, off in reads:
        if off is None:
            eng.add_sequence(r)
        else:
            eng.add_sequence_offset(r, off)


def scan_bound(B, P, M, m):
    """(bound_ms, bound_by) of one offset scan: the window and heads read
    and the scores written once; ``min(2M, 2m)`` columns (the ones that
    can reach the output, ``csrc/offset_scan.cu``'s header says why) of
    ``ceil(m / 64)`` 64-bit words of bit vectors per (head, position)."""
    nbytes = 4 * ((P + 2 * M) + B * M + B * P)
    cols = min(2 * M, 2 * m)
    words = -(-m // 64)
    return bound(nbytes, B * P * cols * words * SCAN_OPS_PER_WORD)


def replay_bound(off, act, clen, W):
    """(bound_ms, bound_by, stepped columns) of a replay of ``[B, R]``
    rows: the band and folds written once, each stepped row's read window
    and its slot's consensus read once; 20 int32 operations per band cell
    per column this data steps (active rows, ``clen - off`` columns)."""
    import torch

    cols = torch.where(act, (clen[:, None] - off).clamp(min=0), 0)
    steps = int(cols.sum())
    stepped = int((cols > 0).sum())
    B, R = off.shape
    nbytes = (4 * B * R * W + 12 * B * R + 2 * (steps + stepped * W)
              + 4 * int(clen.sum()) + 5 * B * R + 4 * B)
    bms, by = bound(nbytes, steps * W * OPS_PER_CELL)
    return bms, by, steps


def phase_late_main():
    """The late-read deployment through ``ConsensusDWFA`` on ``cuda``:
    256 reads x 10 kb at 1 % (the single north star's draw), 64 of them
    cut and added with their offsets, ``min_count=64``, no
    ``initial_band``.  Three searches: ``cold`` records the inputs of its
    first three offset scans, its first three activations and every
    growth replay for ``replay_kernel``; ``timed`` (warm) times the
    scorer's offset, activation and growth calls on the host; ``warm``
    runs with nothing wrapped and gives the warm wall, the launches and
    the device profile.  Returns ``((offset_scan, col_replay,
    run_extend) launches of the warm search, records)``."""
    from waffle_con_tpu_torch import CdwfaConfigBuilder, ConsensusDWFA
    from waffle_con_tpu_torch.ops import replay_kernel as rpk
    from waffle_con_tpu_torch.ops import run_kernel as rk
    from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
    import torch

    t0 = time.perf_counter()
    truth, reads = late_draw()
    gen_s = time.perf_counter() - t0
    n_late = sum(off is not None for _r, off in reads)
    b = CdwfaConfigBuilder().backend("torch").device("cuda")
    for k, v in LATE_CFG.items():
        b = getattr(b, k)(v)
    cfg = b.build()

    records = {"scans": [], "activations": [], "grows": []}
    seen = {"W": None}
    host_s = {"offset": 0.0, "activate": 0.0, "grow_e": 0.0}
    scan0, act0, replay0 = rpk.offset_scan, rpk.activate_row, rpk.replay_rows
    methods = {name: getattr(TorchScorer, name) for name in
               ("best_activation_offset", "activate", "_grow_e")}

    def rec_scan(cons_win, heads, m, wc, P, M, num_symbols):
        if len(records["scans"]) < 3:
            records["scans"].append(
                (cons_win.clone(), heads.clone(), m, wc, P, M, num_symbols))
        return scan0(cons_win, heads, m, wc, P, M, num_symbols)

    def rec_activate(state, slot, read, offset, rd, rl, wc, et):
        if len(records["activations"]) < 3:
            records["activations"].append(
                (_copy_state(state), slot, read, offset, rd, rl, wc, et))
        return act0(state, slot, read, offset, rd, rl, wc, et)

    def rec_replay(off, act, cons, clen, rd, rl, wc, et, E, W):
        seen["W"] = W
        records["grows"].append((off.clone(), act.clone(), cons.clone(),
                                 clen.clone(), rd, rl, wc, et, E, W))
        return replay0(off, act, cons, clen, rd, rl, wc, et, E, W)

    def timed_method(key, fn):
        def call(self, *a, **kw):
            t = time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                host_s[key] += time.perf_counter() - t
        return call

    def wrap(run):
        """The cold search records, the timed one times; the warm one
        runs the scorer and the kernel wrappers as they ship."""
        rpk.offset_scan, rpk.activate_row, rpk.replay_rows = (
            (rec_scan, rec_activate, rec_replay) if run == "cold"
            else (scan0, act0, replay0))
        for name, key in (("best_activation_offset", "offset"),
                          ("activate", "activate"), ("_grow_e", "grow_e")):
            setattr(TorchScorer, name, timed_method(key, methods[name])
                    if run == "timed" else methods[name])

    walls = {}
    try:
        for run in ("cold", "timed", "warm"):
            wrap(run)
            eng = ConsensusDWFA(cfg)
            _add_reads(eng, reads)
            for fn in (rpk.offset_scan_cuda, rpk.replay_rows_cuda,
                       rk.run_extend_cuda):
                fn.launches = 0
            rpk.replay_rows_cuda.activate_launches = 0
            rk.run_extend_cuda.placements = {"smem": 0, "global": 0}
            for fn in (rpk.offset_scan_plain, rpk.replay_rows_plain,
                       rk.run_extend_plain):
                fn.calls = 0
            reset_arena_counts()
            for key in host_s:
                host_s[key] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.consensus()
            torch.cuda.synchronize()
            walls[run] = time.perf_counter() - t0
            launches = (rpk.offset_scan_cuda.launches,
                        rpk.replay_rows_cuda.launches,
                        rk.run_extend_cuda.launches)
            act_launches = rpk.replay_rows_cuda.activate_launches
            plain = (rpk.offset_scan_plain.calls, rpk.replay_rows_plain.calls,
                     rk.run_extend_plain.calls + arena_counts()[1])
            arena_launches = arena_counts()[0]
            ragged_launches = gang_launches()
            branch = branch_launches()
            c = eng.last_search_stats["scorer_counters"]
            plan_refusals(f"late_main {run}", c)
            if not res or res[0].sequence != truth:
                raise AssertionError(f"late_main {run}: consensus != truth")
            if not (launches[0] == c["offset_scan_calls"] > 0
                    and launches[1] > 0 and launches[2] > 0
                    and c["activate_calls"] == n_late
                    and c["grow_e_events"] > 0 and plain == (0, 0, 0)
                    and ragged_launches == c.get("gang_groups", 0)):
                raise AssertionError(
                    f"late_main {run}: launches (offset_scan, col_replay, "
                    f"run_extend) {launches}, plain calls {plain}, counters "
                    f"{c}")
            if run == "timed":
                timed_host = dict(host_s)
        final_W = seen["W"]
        device_ms, by_name = _device_ms(eng.consensus)
    finally:
        wrap("warm")
    st = eng.last_search_stats
    c = st["scorer_counters"]
    # col_replay_kernel<activate, cells> (col_replay_global_kernel<activate>)
    grow_ms = sum(ms for name, ms in by_name.items()
                  if "col_replay" in name and "<false" in name)
    act_ms = sum(ms for name, ms in by_name.items()
                 if "col_replay" in name and "<true" in name)
    line = dict(
        reads=len(reads), late_reads=n_late, length=len(truth),
        gen_s=round(gen_s, 3), cold_s=round(walls["cold"], 3),
        timed_s=round(walls["timed"], 3), warm_s=round(walls["warm"], 3),
        pops=st["nodes_explored"] + st["nodes_ignored"],
        run_calls=c["run_calls"], run_steps=c["run_steps"],
        run_stops=_run_stops(c),
        offset_scan_launches=launches[0], col_replay_launches=launches[1],
        col_replay_activate_launches=act_launches,
        run_kernel_launches=launches[2], plain_calls=list(plain),
        arena_kernel_launches=arena_launches, **arena_counters(c),
        gang_kernel_launches=ragged_launches, **gang_counters(c),
        **plan_refusals("late_main", c),
        activate_calls=c["activate_calls"],
        offset_scan_calls=c["offset_scan_calls"],
        grow_e_events=c["grow_e_events"], replayed_cols=c["replayed_cols"],
        final_W=final_W,
        run_kernel_plan=_plan_fields(rk.run_extend_cuda.last_plan),
        host_s={k: round(v, 4) for k, v in timed_host.items()},
        activation_wall_share=round(
            (timed_host["offset"] + timed_host["activate"]) / walls["timed"],
            4),
        growth_wall_share=round(timed_host["grow_e"] / walls["timed"], 4),
        scores_sum=sum(res[0].scores), profiled_device_ms=device_ms,
        device_ms_by_kernel=dict(
            run_extend=round(_kernel_ms(by_name, "run_extend_kernel"), 3),
            offset_scan=round(_kernel_ms(by_name, "offset_scan_kernel"), 3),
            col_replay_grow=round(grow_ms, 3),
            col_replay_activate=round(act_ms, 3)),
        top_device_ms=dict(list(by_name.items())[:6]),
        device_busy_share=(
            None if device_ms is None
            else round(device_ms / 1e3 / walls["warm"], 4)
        ),
    )
    print("late_main", json.dumps(line), flush=True)
    BASELINE["late"] = dict(
        reads=[r for r, _off in reads], offsets=[off for _r, off in reads],
        config=cfg, want=[(r.sequence, list(r.scores)) for r in res],
        torch_warm_s=walls["warm"])
    ARENA_LAUNCHES["late_main"] = arena_launches
    BRANCH_LAUNCHES["late_main"] = branch[0]
    GANG_LAUNCHES["late_main"] = ragged_launches
    return launches, records


def _scan_inputs(seed, P, M, m, wc=-2, real=None, wild=0):
    """A window of ``real`` (default all) random symbols padded with -2
    and a head of ``m`` random symbols padded with -3, ``wild`` of each
    replaced by the wildcard ``wc``; on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    win = np.full(P + 2 * M, -2, dtype=np.int32)
    n = P + 2 * M if real is None else real
    win[:n] = rng.integers(0, 4, n)
    head = np.full((1, M), -3, dtype=np.int32)
    # the head matches the window at one position, with a few edits
    at = int(rng.integers(0, max(1, n - m)))
    seg = win[at:at + m].copy()
    head[0, :len(seg)] = seg
    flip = rng.choice(m, size=max(1, m // 20), replace=False)
    head[0, flip] = rng.integers(0, 4, len(flip))
    if wild:
        win[rng.choice(n, size=wild, replace=False)] = wc
        head[0, rng.choice(m, size=wild, replace=False)] = wc
    dev = torch.device("cuda")
    return torch.from_numpy(win).to(dev), torch.from_numpy(head).to(dev)


def _replay_store(seed, B, R, length, E, clens, late=(), inactive=(),
                  C=None):
    """A branch store for the replay cases, on the card: ``R`` reads of
    ``generate_test(4, length, R, 1 %)``, slot ``b`` holding the truth
    (slot 1 with every 50th symbol shifted) up to ``clens[b]``; ``late``
    ``(read, offset)`` rows anchored at ``offset`` with the read cut
    there, ``inactive`` ``(slot, read)`` rows off.  Returns ``(state,
    reads, rlen)``."""
    import numpy as np
    import torch
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    truth, reads = generate_test(4, length, R, 0.01, seed=seed)
    reads = list(reads)
    off = np.zeros((B, R), dtype=np.int32)
    for r, o in late:
        reads[r] = reads[r][o:]
        off[:, r] = o
    L = 256
    while L < max(map(len, reads)):
        L *= 2
    rd = np.full((R, L), -1, dtype=np.int16)
    for i, r in enumerate(reads):
        rd[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
    rlen = np.array([len(r) for r in reads], dtype=np.int32)
    C = C or max(512, 1 << (length + 64 - 1).bit_length())
    cons = np.zeros((B, C), dtype=np.int32)
    t = np.frombuffer(truth, dtype=np.uint8).astype(np.int32)
    for b in range(B):
        row = t.copy()
        if b == 1:
            row[::50] = (row[::50] + 1) % 4
        cons[b, :len(row)] = row
    act = np.ones((B, R), dtype=bool)
    for b, r in inactive:
        act[b, r] = False
    W = 2 * E + 2
    dev = torch.device("cuda")
    state = dict(
        D=torch.full((B, R, W), 1 << 20, dtype=torch.int32, device=dev),
        e=torch.zeros((B, R), dtype=torch.int32, device=dev),
        rmin=torch.full((B, R), 1 << 20, dtype=torch.int32, device=dev),
        er=torch.full((B, R), 1 << 20, dtype=torch.int32, device=dev),
        off=torch.from_numpy(off).to(dev), act=torch.from_numpy(act).to(dev),
        cons=torch.from_numpy(cons).to(dev),
        clen=torch.tensor(list(clens), dtype=torch.int32, device=dev),
    )
    return (state, torch.from_numpy(rd).to(dev),
            torch.from_numpy(rlen).to(dev))


def _same(a, b):
    """Max absolute difference of two int tensors (or tuples of them)."""
    if isinstance(a, (tuple, list)):
        return max(_same(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _launch_device_ms(launch, n):
    """Device ms of one ``launch()`` (a launch that does not synchronise):
    ``n`` of them queued back to back behind a spin kernel
    (``torch.cuda._sleep``) that keeps the card busy while the host queues
    them, timed by CUDA events around the ``n``.  The events around one
    call time the host's launch too; here it drops out."""
    import torch

    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * n)  # ~0.5 ms of spinning a launch
    start.record()
    for _ in range(n):
        launch()
    stop.record()
    torch.cuda.synchronize()
    return round(start.elapsed_time(stop) / n, 5)


def _scan_case(label, cons_win, heads, m, wc, P, M, nsym, reps=20):
    from waffle_con_tpu_torch.ops import replay_kernel as rpk

    got = rpk.offset_scan_cuda(cons_win, heads, m, wc, P, M, nsym)
    plan = rpk.offset_scan_cuda.last_plan
    held = []
    p_ms = _time_cuda(lambda: held.append(
        rpk.offset_scan_plain(cons_win, heads, m, wc, P, M)), 1)
    err = _same(got, held[0])
    if err:
        raise AssertionError(f"{label}: offset_scan kernel != plain ({err})")
    k_ms = _time_cuda(
        lambda: rpk.offset_scan_cuda(cons_win, heads, m, wc, P, M, nsym),
        reps)
    dev_ms = _launch_device_ms(
        lambda: rpk.offset_scan_cuda(cons_win, heads, m, wc, P, M, nsym),
        reps)
    bms, by = scan_bound(heads.shape[0], P, M, m)
    line = dict(case=label, B=heads.shape[0], P=P, M=M, m=m, wc=wc,
                group=plan.group, threads=plan.threads, blocks=plan.blocks,
                column=plan.column, table=plan.table,
                smem_bytes=plan.smem_bytes, kernel_ms=round(k_ms, 4),
                device_ms=dev_ms, plain_ms=round(p_ms, 3), bound_ms=bms,
                bound_by=by, best=int(held[0].min()))
    print("replay_kernel", json.dumps(line), flush=True)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by), err


def _grow_case(label, state, rd, rl, wc, et, E, reps=3):
    from waffle_con_tpu_torch.ops import replay_kernel as rpk

    W = 2 * E + 2
    args = (state["off"], state["act"], state["cons"], state["clen"], rd, rl,
            wc, et, E, W)
    got = rpk.replay_rows_cuda(*args)
    plan = rpk.replay_rows_cuda.last_plan
    held = []
    p_ms = _time_cuda(lambda: held.append(rpk.replay_rows_plain(*args)), 1)
    err = _same(got, held[0])
    if err:
        raise AssertionError(f"{label}: col_replay kernel != plain ({err})")
    k_ms = _time_cuda(lambda: rpk.replay_rows_cuda(*args), reps)
    dev_ms = _launch_device_ms(lambda: rpk.replay_rows_cuda(*args), reps)
    bms, by, steps = replay_bound(state["off"], state["act"], state["clen"],
                                  W)
    B, R = state["off"].shape
    line = dict(case=label, mode="grow", B=B, R=R, W=W,
                clen_max=int(state["clen"].max()), stepped_cols=steps,
                **_replay_plan_fields(plan), kernel_ms=round(k_ms, 4),
                device_ms=dev_ms, plain_ms=round(p_ms, 3), bound_ms=bms,
                bound_by=by)
    print("replay_kernel", json.dumps(line), flush=True)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by), err


def _replay_plan_fields(plan):
    return dict(placement=plan.placement, cells=plan.cells,
                row_warps=plan.row_warps, ctas=plan.ctas, warps=plan.warps,
                blocks=plan.blocks, smem_bytes=plan.smem_bytes)


def _activate_case(label, state, rd, rl, slot, read, offset, wc, et,
                   want_ovf, reps=5):
    """One row caught up by the kernel and by the twin on copies of
    ``state``; both stores and both overflow flags must be equal, the
    flag ``want_ovf`` (any, when ``None``), and an overflow must leave
    the store as it was."""
    from waffle_con_tpu_torch.ops import replay_kernel as rpk
    import torch

    st_k, st_p = _copy_state(state), _copy_state(state)
    ovf_k = rpk.activate_row_cuda(st_k, slot, read, offset, rd, rl, wc, et)
    plan = rpk.replay_rows_cuda.last_plan
    held = []
    p_ms = _time_cuda(lambda: held.append(rpk.activate_row_plain(
        st_p, slot, read, offset, rd, rl, wc, et)), 1)
    if ovf_k != held[0] or want_ovf not in (None, ovf_k):
        raise AssertionError(
            f"{label}: overflow kernel {ovf_k}, plain {held[0]}, expected "
            f"{want_ovf}")
    err = max(_same(st_k[k], st_p[k]) for k in state)
    if ovf_k:
        err = max(err, max(_same(st_k[k], state[k]) for k in state))
    if err:
        raise AssertionError(f"{label}: col_replay kernel != plain ({err})")
    k_ms = _time_cuda(lambda: rpk.activate_row_cuda(
        st_k, slot, read, offset, rd, rl, wc, et), reps)
    # the launch alone, without the host's read of the overflow word
    flag = torch.empty(1, dtype=torch.int32, device=rd.device)
    dev_ms = _launch_device_ms(lambda: rpk._launch_col_replay(
        1, st_k, None, flag, rd, rl, slot, read, offset, wc, et, plan), reps)
    W = state["D"].shape[2]
    cols = max(0, int(state["clen"][slot]) - offset)
    one = lambda t: t[slot:slot + 1, read:read + 1]  # noqa: E731
    bms, by, _ = replay_bound(
        torch.full_like(one(state["off"]), offset),
        torch.ones_like(one(state["act"])), state["clen"][slot:slot + 1], W)
    line = dict(case=label, mode="activate", W=W, cols=cols, overflow=ovf_k,
                **_replay_plan_fields(plan), kernel_ms=round(k_ms, 4),
                device_ms=dev_ms, plain_ms=round(p_ms, 3),
                bound_ms=bms, bound_by=by)
    print("replay_kernel", json.dumps(line), flush=True)
    return err


def phase_replay_kernel(small_only: bool, records=None):
    """Both late-read kernels against their plain twins on the card,
    every output compared bitwise: the offset scan on the default window
    (one thread a position), one position, the plan's edges (the whole
    head at m = 64, groups of 2 and 4 lanes at m = 65 and 129), a wide
    window with the wildcard, long heads (m = 1,500 and, at M = 32,768,
    1,100: a warp a position; m = 2,100: the column in shared memory;
    m = 7,000: Peq in device memory) and the deployment's first three
    calls; the column replay catching one row up over 50, 100, 5,000 and
    no columns (the offset at the branch's end, and past it), an overflow
    at E=8 that commits nothing, one row on a CTA (W=2050), on clusters
    (W=32770, W=65538) and on the device-memory last resort (W=139266),
    and the deployment's first three activations, and growth replays of
    the whole store (16 x 256 rows to W=34 and 16 x 128 to W=66, more
    rows than warps on the card; W=258 at clen 6,000 with mixed anchors,
    inactive rows and free slots; W=2050 on CTAs; W=32770 and W=65538 on clusters;
    W=139266 in device memory) and the deployment's own.  ``small_only``
    keeps one case of each placement.  Returns the kernel table's numbers
    of both kernels (from the deployment's calls when ``late_main`` ran)
    and the max error of each."""
    records = records or {"scans": [], "activations": [], "grows": []}
    err_scan = err_rep = 0
    scan_t = rep_t = None
    # -- offset scan (label, P, M, m, wc, real symbols, wildcards, reps)
    cases = [("scan/default_window", 64, 64, 50, -2, 100, 0, 20),
             ("scan/one_position", 1, 64, 40, -2, None, 0, 20),
             # the plan's edges: groups of 2 and 4 lanes a position
             ("scan/m65", 64, 128, 65, -2, 200, 0, 5),
             ("scan/m129", 64, 256, 129, 4, 300, 4, 5),
             # past 2,048 rows: the column in shared memory
             ("scan/smem_column", 2, 4096, 2100, -2, 4400, 0, 3)]
    if not small_only:
        cases += [("scan/whole_head", 64, 64, 64, -2, 100, 0, 20),
                  ("scan/wide_wildcard", 128, 256, 200, 4, 500, 6, 20),
                  # long heads: a warp a position, the column in registers
                  ("scan/long_head", 2, 2048, 1500, -2, 4000, 0, 20),
                  ("scan/global_column", 1, 32768, 1100, -2, 3000, 0, 20),
                  # Peq too large for shared memory: in device memory
                  ("scan/global_table", 2, 8192, 7000, -2, 7500, 0, 2)]
    for k, (label, P, M, m, wc, real, wild, reps) in enumerate(cases):
        win, head = _scan_inputs(10 + k, P, M, m, wc, real, wild)
        # ids 0-3 and the wildcard's 4
        t, e = _scan_case(label, win, head, m, wc, P, M, 5, reps)
        err_scan = max(err_scan, e)
        scan_t = scan_t or t
    for k, (win, head, m, wc, P, M, nsym) in enumerate(records["scans"]):
        t, e = _scan_case(f"scan/deployment_{k}", win, head, m, wc, P, M,
                          nsym)
        err_scan = max(err_scan, e)
        if k == 0:
            scan_t = t
    # -- column replay, activation mode
    # read r cut where it is activated: 50, 100 and 5,000 columns behind
    # the branch's 5,600
    rows = ((3, 50), (7, 100)) + (() if small_only else ((11, 5000),))
    st, rd, rl = _replay_store(20, 4, 16, 6000, 128, (5600, 5600, 0, 0),
                               late=[(r, 5600 - cols) for r, cols in rows])
    for r, cols in rows:
        err_rep = max(err_rep, _activate_case(
            f"activate/{cols}_cols", st, rd, rl, 0, r, 5600 - cols, -2,
            False, False))
    # no column to catch up: the offset at the branch's end, and past it
    for label, r, offset in (("activate/0_cols", 1, 5600),
                             ("activate/past_end", 2, 5700)):
        err_rep = max(err_rep, _activate_case(label, st, rd, rl, 0, r,
                                              offset, -2, False, False))
    # slot 1's consensus differs from the read every 50th symbol
    st, rd, rl = _replay_store(21, 4, 16, 2000, 8, (1500, 1500, 0, 0),
                               late=((5, 200),))
    err_rep = max(err_rep, _activate_case(
        "activate/overflow_E8", st, rd, rl, 1, 5, 200, -2, False, True))
    # one row over 100 columns on each wide placement: a CTA (E = 1024),
    # clusters of 4 and 8 CTAs (E = 16384, the first width past one CTA's
    # shared memory for a row's two columns, and E = 32768) and the
    # device-memory last resort
    wide = [("activate/W2050_cta", 1024, 3),
            ("activate/global_band", 16384, 5)]
    if not small_only:
        wide += [("activate/W65538_cluster", 32768, 3),
                 ("activate/W139266_global", 69632, 1)]
    for label, E, reps in wide:
        st, rd, rl = _replay_store(25, 2, 4, 700, E, (600, 0),
                                   late=((1, 500),))
        err_rep = max(err_rep, _activate_case(
            label, st, rd, rl, 0, 1, 500, -2, False, False, reps))
    for k, (st, slot, read, offset, rd, rl, wc, et) in enumerate(
            records["activations"]):
        err_rep = max(err_rep, _activate_case(
            f"activate/deployment_{k}", st, rd, rl, slot, read, offset, wc,
            et, None))
    # -- column replay, growth mode
    grows = [("grow/B16_R256_W34_clen300",
              dict(seed=22, B=16, R=256, length=400, E=16,
                   clens=[300] * 16)),
             ("grow/W2050", dict(seed=24, B=4, R=16, length=700, E=1024,
                                 clens=[600, 400, 0, 600])),
             ("grow/W32770_global", dict(seed=26, B=2, R=8, length=700,
                                         E=16384, clens=[600, 0],
                                         late=((3, 200),)))]
    if not small_only:
        grows += [
            ("grow/B16_R128_W66_clen300",
             dict(seed=27, B=16, R=128, length=400, E=32,
                  clens=[300] * 16)),
            ("grow/W258_clen6000_mixed",
             dict(seed=23, B=16, R=64, length=6200, E=128,
                  clens=[6000, 5000, 4000, 0, 6000, 300] + [0] * 10,
                  late=[(r, 100 * r) for r in range(3, 64, 4)],
                  inactive=[(b, r) for b in range(16) for r in (1, 30)])),
            ("grow/W65538_cluster", dict(seed=28, B=2, R=4, length=400,
                                         E=32768, clens=[300, 0],
                                         late=((3, 100),))),
            ("grow/W139266_global", dict(seed=29, B=1, R=2, length=300,
                                         E=69632, clens=[60],
                                         late=((1, 20),))),
        ]
    for label, spec in grows:
        st, rd, rl = _replay_store(**spec)
        reps = 3 if spec["E"] <= 16384 else 1
        t, e = _grow_case(label, st, rd, rl, -2, False, spec["E"], reps)
        err_rep = max(err_rep, e)
        if label == "grow/W258_clen6000_mixed" or rep_t is None:
            rep_t = t
    for k, (off, act, cons, clen, rd, rl, wc, et, E, W) in enumerate(
            records["grows"]):
        st = dict(off=off, act=act, cons=cons, clen=clen)
        t, e = _grow_case(f"grow/deployment_{k}", st, rd, rl, wc, et, E)
        err_rep = max(err_rep, e)
        rep_t = t  # the deployment's last (widest) growth
    return (scan_t, err_scan), (rep_t, err_rep)


def phase_late_oracle():
    """The ``"python"`` oracle and ``"torch"`` on ``cuda`` give identical
    results, scores included, with late reads and the default band: the
    single engine on 16 reads x 1 kb at 2 % (every 4th read cut at
    100-500), the dual engine on the same shape with 2 SNPs, and the
    ``length_gap_001`` fixture."""
    from waffle_con_tpu_torch import (
        CdwfaConfigBuilder,
        ConsensusCost,
        ConsensusDWFA,
        DualConsensusDWFA,
    )
    from waffle_con_tpu_torch.ops import replay_kernel as rpk
    from waffle_con_tpu_torch.utils.fixtures import load_dual_fixture

    truth, single = late_draw(16, 1000, 0.02, (100, 500), seed=1)
    t1, t2, dual = late_dual_draw()
    gap, _ = load_dual_fixture("length_gap_001", False,
                               ConsensusCost.L2_DISTANCE)
    cases = [
        ("single", ConsensusDWFA, single, dict(min_count=4)),
        ("dual", DualConsensusDWFA, dual, dict(min_count=4)),
        ("length_gap_001", DualConsensusDWFA, [(r, None) for r in gap],
         dict(wildcard=ord("*"), min_count=2, dual_max_ed_delta=5,
              max_queue_size=1000,
              consensus_cost=ConsensusCost.L2_DISTANCE)),
    ]
    seen = {}
    for name, engine, reads, fields in cases:
        got = {}
        l0 = (rpk.offset_scan_cuda.launches, rpk.replay_rows_cuda.launches)
        for be in ("python", "torch"):
            b = CdwfaConfigBuilder().backend(be).device("cuda")
            for k, v in fields.items():
                b = getattr(b, k)(v)
            eng = engine(b.build())
            _add_reads(eng, reads)
            t0 = time.perf_counter()
            res = eng.consensus()
            got[be + "_s"] = round(time.perf_counter() - t0, 3)
            got[be] = (_dual_key(res) if engine is DualConsensusDWFA
                       else [(c.sequence, list(c.scores)) for c in res])
        if got["python"] != got["torch"]:
            raise AssertionError(f"late_oracle: {name}: python and torch "
                                 "results differ")
        c = eng.last_search_stats["scorer_counters"]
        first = got["torch"][0]
        if name == "single":
            found = first[0] == truth
        elif name == "dual":
            found = {first[0][0], first[1] and first[1][0]} == {t1, t2}
        else:
            found = None
        seen[name] = dict(
            results=len(got["torch"]), truth=found,
            activate_calls=c["activate_calls"],
            offset_scan_calls=c["offset_scan_calls"],
            grow_e_events=c["grow_e_events"],
            offset_scan_launches=rpk.offset_scan_cuda.launches - l0[0],
            col_replay_launches=rpk.replay_rows_cuda.launches - l0[1],
            python_s=got["python_s"], torch_s=got["torch_s"])
    print("late_oracle", json.dumps(dict(cases=seen, identical=True)),
          flush=True)


# ---------------------------------------------------------------------
# phase 13: the K-node pop arena


class ArenaRecorder:
    """Records the inputs (a copy of the branch store included) and the
    packed output of the first ``limit`` arena calls while active:
    ``arena_kernel.arena`` is wrapped, nothing else changes."""

    def __init__(self, limit):
        self.limit = limit
        self.calls = []

    def __enter__(self):
        from waffle_con_tpu_torch.ops import arena_kernel as ak

        self._orig = ak.arena

        def rec(state, reads, rlen, slots, kinds, lc, pc, tr, mc_tab,
                imb_tab, args):
            keep = len(self.calls) < self.limit
            if keep:
                import numpy as np

                state0 = _copy_state(state)
                inputs = (reads, rlen, list(slots), list(kinds),
                          np.array(lc), np.array(pc), np.array(tr),
                          np.array(mc_tab), np.array(imb_tab), args)
            out = self._orig(state, reads, rlen, slots, kinds, lc, pc, tr,
                             mc_tab, imb_tab, args)
            if keep:
                self.calls.append(dict(state=state0, inputs=inputs,
                                       out=out.clone()))
            return out

        ak.arena = rec
        return self

    def __exit__(self, *exc):
        from waffle_con_tpu_torch.ops import arena_kernel as ak

        ak.arena = self._orig


def arena_counters(c):
    """The arena's scorer counters of a search (its stop codes, the
    split-absorption diagnostics of its code-1 stops folded into one)."""
    out = {k: v for k, v in c.items()
           if k.startswith("arena_") and not k.startswith("arena_s1_")}
    out["arena_s1_diag"] = {k[len("arena_s1_"):]: v for k, v in c.items()
                            if k.startswith("arena_s1_")}
    return out


def _arena_features(rec):
    """What one recorded arena call exercises (from its live output)."""
    from waffle_con_tpu_torch.ops import arena_kernel as ak

    st = rec["state"]
    (_rd, _rl, slots, kinds, *_rest, args) = rec["inputs"]
    K = len(kinds)
    R, W = st["D"].shape[1:]
    res = ak.unpack(rec["out"].cpu().numpy(), K, R, args.a_real,
                    args.max_steps)
    feats = {f"code{res.code}", f"W{W}"}
    if any(K <= v < 2 * K for v in res.hist[:res.nsteps]):
        feats.add("discard")
    if res.cre_count:
        feats.add(f"create_mode{args.create_mode}")
    if res.code == 1 and res.stop_diag // 64 >= 2 and not res.stop_diag & 8:
        feats.add("pool_exhausted")
    if args.weighted:
        feats.add("weighted")
    if args.mc_dyn:
        feats.add("mc_dyn")
    if args.l2:
        feats.add("l2")
    for n in range(args.n_live):
        for f in ((2 * n, 2 * n + 1) if kinds[n] == 1 else (2 * n,)):
            off = st["off"][slots[f]][st["act"][slots[f]]]
            if off.numel() and int(off.max()) != int(off.min()):
                feats.add("mixed_offsets")
    return feats, res


ARENA_FEATURES = ("code1", "code2", "code3", "code4", "code5", "discard",
                  "create_mode1", "create_mode2", "pool_exhausted",
                  "mixed_offsets", "weighted", "mc_dyn", "l2", "W514",
                  "W2050")


def _dual_workload(seq_len=200, per_hap=6, er=0.01):
    """``tests/test_arena_creation.py``'s dual draw: two haplotypes 2 SNPs
    apart, ``per_hap`` reads each."""
    import numpy as np
    from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

    truth, reads1 = generate_test(4, seq_len, per_hap, er, seed=1)
    h2 = bytearray(truth)
    h2[seq_len // 3] = (h2[seq_len // 3] + 1) % 4
    h2[2 * seq_len // 3] = (h2[2 * seq_len // 3] + 2) % 4
    reads2 = [corrupt(bytes(h2), er, np.random.default_rng(50 + i))
              for i in range(per_hap)]
    return [(r, None) for r in list(reads1) + reads2]


def arena_draws():
    """Small searches whose arena calls reach every stop code, discards,
    both creation modes, a full creation pool, mixed offsets, weighted,
    ``mc_dyn`` and L2 votes, W = 514 and 2050, and the largest cluster
    (80 reads, which the store pads to R = 128: 16 CTAs): ``(label,
    engine, reads, config fields, creation pool size or None)``."""
    from waffle_con_tpu_torch import ConsensusCost
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    ties = [(r, None) for r in generate_test(4, 400, 8, 0.03, seed=3)[1]]
    dual = _dual_workload()
    _t1, _t2, late = late_dual_draw(n=6)
    return [
        ("single_ties", "ConsensusDWFA", ties, dict(min_count=2), None),
        ("dual_split", "DualConsensusDWFA", dual, dict(min_count=3), None),
        ("dual_pool2", "DualConsensusDWFA", dual, dict(min_count=3), 2),
        ("dual_weighted", "DualConsensusDWFA", dual,
         dict(min_count=3, weighted_by_ed=True), None),
        ("dual_mc_dyn", "DualConsensusDWFA", dual,
         dict(min_count=2, min_af=0.3), None),
        ("dual_l2", "DualConsensusDWFA", dual,
         dict(min_count=3, consensus_cost=ConsensusCost.L2_DISTANCE), None),
        ("dual_late", "DualConsensusDWFA", late, dict(min_count=3), None),
        ("dual_W514", "DualConsensusDWFA", dual,
         dict(min_count=3, initial_band=216), None),
        ("dual_W2050", "DualConsensusDWFA", dual,
         dict(min_count=3, initial_band=1000), None),
        ("dual_80reads", "DualConsensusDWFA", _dual_workload(per_hap=40),
         dict(min_count=8), None),
    ]


def record_arena_draws(device, per_draw=200):
    """Run every draw of :func:`arena_draws` on ``device``, recording its
    arena calls; returns ``[(label, [record, ...]), ...]``."""
    import waffle_con_tpu_torch as T
    from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer

    out = []
    pool0 = TorchScorer.ARENA_POOL
    for label, engine, reads, fields, pool in arena_draws():
        b = T.CdwfaConfigBuilder().backend("torch").device(device)
        for k, v in fields.items():
            b = getattr(b, k)(v)
        eng = getattr(T, engine)(b.build())
        _add_reads(eng, reads)
        TorchScorer.ARENA_POOL = pool or pool0
        try:
            with ArenaRecorder(per_draw) as rec:
                eng.consensus()
        finally:
            TorchScorer.ARENA_POOL = pool0
        out.append((label, rec.calls))
    return out


def _cut_arena_call(rec, n):
    """A recorded call on the first ``n`` reads of its store (the scorer
    pads R to a power of two of at least 16, so a one-CTA cluster and an
    odd R arise only so), its output from the plain twin."""
    from waffle_con_tpu_torch.ops import arena_kernel as ak

    (rd, rl, *rest) = rec["inputs"]
    st, rd, rl = _cut_reads(rec["state"], rd, rl, n)
    inputs = (rd, rl, *rest)
    return dict(state=st, inputs=inputs,
                out=ak.arena_plain(_copy_state(st), *inputs))


#: (draw, reads kept) of the cut calls: a one-CTA cluster with an odd R,
#: an odd R over 2 CTAs, and 8 CTAs of 5 reads whose last owns none
ARENA_CUTS = (("dual_split", 7), ("dual_split", 13), ("dual_80reads", 33))


def select_arena_cases(recorded):
    """The first call of each draw and every call that exercises a
    feature no earlier selected call did.  Returns ``[(label, record,
    features)]`` and the features covered."""
    seen, cases = set(), []
    for label, calls in recorded:
        for i, rec in enumerate(calls):
            feats, _res = _arena_features(rec)
            if i == 0 or feats - seen:
                cases.append((f"{label}/{i}", rec, sorted(feats)))
                seen |= feats
    return cases, seen


def _arena_call_plan(rec):
    """``plan_arena``'s plan of one recorded call."""
    import numpy as np
    from waffle_con_tpu_torch.ops import arena_kernel as ak

    st = rec["state"]
    (_rd, _rl, _slots, kinds, lc, *_rest, args) = rec["inputs"]
    return ak.plan_arena(len(kinds), st["D"].shape[1], st["D"].shape[2],
                         args.a_real, np.asarray(lc).shape[1],
                         st["cons"].shape[1])


def arena_bound(stepped_rows, W, in_words, out_words):
    """(bound_ms, bound_by) of one arena call: each stepped row (a
    commit's or a child's side of one read) read and written once at
    ``W`` cells of 20 int32 operations, the packed input and output
    moved once."""
    nbytes = 2 * 4 * stepped_rows * W + 4 * (in_words + out_words)
    return bound(nbytes, stepped_rows * W * OPS_PER_CELL)


def _arena_real_rows(res, slots, args):
    """Store slots of the sides some node owns after the call."""
    out = []
    for f in range(2 * len(res.kinds)):
        n = f // 2
        if n < args.n_live + res.cre_count and (f % 2 == 0
                                                or res.kinds[n] == 1):
            out.append(slots[f])
    return out


def arena_case(label, rec, feats, device="cuda", reps=3):
    """One recorded call through the kernel and the twin on copies of its
    store: the packed outputs (and the live run's), and every row some
    node owns, must be equal.  Prints the case's line and returns its
    timing and error."""
    import numpy as np
    import torch
    from waffle_con_tpu_torch.ops import arena_kernel as ak

    kern = ak.arena_cuda if device == "cuda" else ak.arena_plain
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    (rd, rl, slots, kinds, lc, pc, tr, mc_tab, imb_tab, args) = rec["inputs"]
    call = (rd, rl, slots, kinds, lc, pc, tr, mc_tab, imb_tab, args)
    st_k, st_p = _copy_state(rec["state"]), _copy_state(rec["state"])
    out_k = kern(st_k, *call)
    sync()
    t0 = time.perf_counter()
    out_p = ak.arena_plain(st_p, *call)
    sync()
    p_ms = (time.perf_counter() - t0) * 1e3
    stepped = ak.arena_plain.stepped_rows
    err = max(_same(out_k, out_p), _same(out_k, rec["out"]))
    K = len(kinds)
    R, W = st_k["D"].shape[1:]
    res = ak.unpack(out_k.cpu().numpy(), K, R, args.a_real, args.max_steps)
    for slot in _arena_real_rows(res, slots, args):
        for name in ("D", "e", "rmin", "er", "off", "act", "clen"):
            err = max(err, _same(st_k[name][slot], st_p[name][slot]))
        n = int(st_k["clen"][slot])
        err = max(err, _same(st_k["cons"][slot, :n], st_p["cons"][slot, :n]))
    if err:
        raise AssertionError(f"{label}: arena kernel != plain ({err})")
    # kernel time: CUDA events around the launch alone, each on a fresh
    # copy of the recorded store (a launch steps its rows in place)
    k_ms = None
    if device == "cuda":
        total = 0.0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        for _ in range(reps):
            st = _copy_state(rec["state"])
            torch.cuda.synchronize()
            start.record()
            kern(st, *call)
            stop.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(stop)
        k_ms = total / reps
    lay_in = ak.arena_in_layout(K, lc.shape[1], len(mc_tab), len(imb_tab))
    bms, by = arena_bound(stepped, W, lay_in["imb_tab"][1], out_k.numel())
    plan = _arena_call_plan(rec)
    line = dict(
        case=label, K=K, R=R, W=W, A=args.a_real, n_live=args.n_live,
        create_mode=args.create_mode, nsteps=res.nsteps, code=res.code,
        creations=res.cre_count, stepped_rows=stepped,
        features=feats, plan=plan._asdict(),
        kernel_ms=None if k_ms is None else round(k_ms, 4),
        plain_ms=round(p_ms, 3), bound_ms=bms, bound_by=by,
        max_abs_err=err, events_per_ms=(
            None if not k_ms else round(res.nsteps / k_ms, 2)),
    )
    print("arena_kernel", json.dumps(line), flush=True)
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bms, bound_by=by), err


def arena_breakdown(label, rec, reps=3):
    """The profiled variant of the arena kernel on a recorded call: each
    part's share of the launch's clock64 total, scaled by the launch's
    time (CUDA events), in µs an event (``nsteps``, as the searches'
    ``arena_steps`` count them).  Prints one ``arena_breakdown`` line."""
    import torch
    from waffle_con_tpu_torch.ops import arena_kernel as ak

    call = rec["inputs"]
    kinds, args = call[3], call[-1]
    prof = torch.zeros(len(ak.PROF_FIELDS), dtype=torch.int64, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    ms, cycles = 0.0, None
    for _ in range(reps):
        st = _copy_state(rec["state"])
        torch.cuda.synchronize()
        start.record()
        out = ak.arena_cuda(st, *call, profile=prof)
        stop.record()
        torch.cuda.synchronize()
        ms += start.elapsed_time(stop) / reps
        got = prof.cpu().numpy()
        cycles = got if cycles is None else cycles + got
    if _same(out, rec["out"]):
        raise AssertionError(f"{label}: the profiled arena kernel differs")
    f = dict(zip(ak.PROF_FIELDS, (int(v) for v in cycles)))
    nsteps = ak.unpack(out.cpu().numpy(), len(kinds), st["D"].shape[1],
                       args.a_real, args.max_steps).nsteps
    # a part's share of the clocks, times the launch's µs, per event
    us = ms * 1e3 / nsteps / f["total"]
    parts = {k: f[k] * us for k in ak.PROF_FIELDS[:5]}
    parts["setup_and_results"] = (f["total"] - sum(
        f[k] for k in ak.PROF_FIELDS[:5])) * us
    parts["total"] = ms * 1e3 / nsteps
    line = dict(
        case=label, plan=_arena_call_plan(rec)._asdict(), events=nsteps,
        loop_iterations=f["events"] // reps, ms=round(ms, 4),
        clock_mhz=round(f["total"] / (ms * reps * 1e3), 1),
        us_per_event={k: round(v, 3) for k, v in parts.items()})
    print("arena_breakdown", json.dumps(line), flush=True)
    return line


def phase_arena_kernel(small_only, records=None, device="cuda"):
    """The arena kernel against its plain twin on the card, every output
    and every owned row of the store bitwise: the first three arena calls
    of ``dual_main`` and the first of ``priority_main`` (a group's call
    through its ``SubsetScorer``) when those phases ran, and the calls of
    small searches chosen to reach every stop code, discards on the
    device, creation in both modes, a full creation pool, mixed offsets,
    weighted, ``mc_dyn`` and L2 votes, and W = 514 and 2050, and
    ``ARENA_CUTS``' calls on fewer reads.  Fails when a feature is not
    reached, or no case's plan is a one-CTA cluster, the largest cluster
    or an odd R.  Returns the kernel table's timing (from ``dual_main``'s
    first call when recorded) and the largest error."""
    from waffle_con_tpu_torch.ops import arena_kernel as ak

    records = records or {}
    cases = []
    for path in ("dual_main", "priority_main"):
        for i, rec in enumerate(records.get(path, [])):
            cases.append((f"{path}/{i}", rec, sorted(_arena_features(rec)[0])))
    main_cases = len(cases)
    if device == "cuda":
        for path in ("dual_main", "priority_main"):
            if records.get(path):
                arena_breakdown(f"{path}/0", records[path][0])
    recorded_draws = record_arena_draws(device,
                                        per_draw=8 if small_only else 200)
    picked, seen = select_arena_cases(recorded_draws)
    missing = [] if small_only else sorted(set(ARENA_FEATURES) - seen)
    if missing:
        raise AssertionError(f"arena_kernel: features not reached {missing}")
    cases += picked
    first = {label: calls[0] for label, calls in recorded_draws if calls}
    for draw, n in ARENA_CUTS:
        if draw in first:
            rec = _cut_arena_call(first[draw], n)
            cases.append((f"{draw}/0/R{n}", rec,
                          sorted(_arena_features(rec)[0])))
    # (odd R, cluster) of every case's plan
    shapes = {(rec["state"]["D"].shape[1] % 2 == 1,
               _arena_call_plan(rec).cluster) for _l, rec, _f in cases}
    clusters = {c for _odd, c in shapes}
    if not ({1, ak.MAX_CLUSTER} <= clusters
            and any(odd for odd, _c in shapes)):
        raise AssertionError(f"arena_kernel: plans not reached (odd R, "
                             f"cluster) {sorted(shapes)}")
    worst, table = 0, None
    for i, (label, rec, feats) in enumerate(cases):
        timing, err = arena_case(label, rec, feats, device)
        worst = max(worst, err)
        if table is None and (i < main_cases or not main_cases):
            table = timing
    print("arena_kernel", json.dumps(dict(
        cases=len(cases), recorded_main_calls=main_cases,
        features=sorted(seen), identical=True)), flush=True)
    return table, worst


# ---------------------------------------------------------------------
# phase 14: the C++ engines on the card's host


def _host_cpu():
    """The host CPU's model and ``os.cpu_count()``.  The model is the
    ``model name`` of ``/proc/cpuinfo``, else ``lscpu``'s ``Model name``,
    else the machine type and the vendor, family and model numbers
    ``/proc/cpuinfo`` gives; an empty or ``unknown`` name counts as
    missing (a virtual machine may report its model so)."""
    import os
    import platform

    def known(val):
        return val if val and val.strip().lower() != "unknown" else None

    fields = {}
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as fh:
            for ln in fh:
                key, _, val = ln.partition(":")
                if known(val):
                    fields.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    model = fields.get("model name")
    if not model:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=10).stdout
        except (OSError, subprocess.SubprocessError):
            out = ""
        for ln in out.splitlines():
            key, _, val = ln.partition(":")
            if key.strip() == "Model name" and known(val):
                model = val.strip()
                break
    if not model:
        model = " ".join(filter(None, (
            platform.machine(), fields.get("vendor_id"),
            fields.get("cpu family") and "family " + fields["cpu family"],
            fields.get("model") and "model " + fields["model"])))
    return model or "unknown", os.cpu_count()


def _gxx_version():
    out = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.splitlines()[0]


def _torch_run(name, spec):
    """One warm ``"torch"`` search of a deployment on ``cuda``, as its
    main phase runs it (engine built and fed untimed): ``(result as plain
    data, seconds)``."""
    import torch
    from waffle_con_tpu_torch import (
        ConsensusDWFA, DualConsensusDWFA, PriorityConsensusDWFA)

    if name == "priority":
        eng = PriorityConsensusDWFA(spec["config"])
        for chain in spec["chains"]:
            eng.add_sequence_chain(chain)
    else:
        eng = (DualConsensusDWFA if name == "dual"
               else ConsensusDWFA)(spec["config"])
        _add_reads(eng, zip(spec["reads"],
                            spec.get("offsets") or [None] * len(spec["reads"])))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.consensus()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _torch_run.last_engine = eng
    if name == "dual":
        got = _dual_key(res)
    elif name == "priority":
        got = _priority_key(res)
    else:
        got = [(c.sequence, list(c.scores)) for c in res]
    return got, wall


#: the engine of the last ``_torch_run`` (its counters)
_torch_run.last_engine = None


def _cpp_run(name, spec):
    """One C++ engine run of a deployment: ``(result as plain data,
    seconds)``."""
    from waffle_con_tpu_torch import native

    t0 = time.perf_counter()
    if name == "dual":
        got = _dual_key(native.native_dual_consensus(
            spec["reads"], config=spec["config"]))
    elif name == "priority":
        got = _priority_key(native.native_priority_consensus(
            spec["chains"], config=spec["config"]))
    else:
        got = [(seq, list(sc)) for seq, sc in native.native_consensus(
            spec["reads"], spec["offsets"], spec["config"])]
    return got, time.perf_counter() - t0


def phase_native_baseline(runs=2):
    """The port's C++ engines (``waffle_con_tpu_torch/native``, built here
    with ``g++``) on the deployments the main phases ran, ``runs`` times
    each, on the card's host, alternating with as many warm ``"torch"``
    searches on ``cuda``: every result must equal the main phase's
    ``"torch"`` result byte for byte.  One line per deployment with both
    sides' walls and the ratio of their minima; then a 16 x 1 kb
    draw at 2 % (single, and dual with 2 SNPs) through the port's engines
    on ``backend("native")`` against ``"torch"`` on ``cuda``."""
    import platform

    from waffle_con_tpu_torch import (
        CdwfaConfigBuilder, ConsensusDWFA, DualConsensusDWFA)
    from waffle_con_tpu_torch import native
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    if not BASELINE:
        raise AssertionError("native_baseline needs main, dual_main, "
                             "priority_main or late_main before it")
    gxx = _gxx_version()
    t0 = time.perf_counter()
    native.build(rebuild=True)
    build_s = time.perf_counter() - t0
    model, cores = _host_cpu()
    print("native_build", json.dumps(dict(
        build_s=round(build_s, 3), gxx=gxx, cpu_model=model,
        cpu_count=cores, machine=platform.machine(),
        library=native.library_path().name)), flush=True)
    for name in ("single", "dual", "priority", "late"):
        spec = BASELINE.get(name)
        if spec is None:
            continue
        walls = {"cpp": [], "torch": []}
        for _ in range(runs):
            for side, run in (("torch", _torch_run), ("cpp", _cpp_run)):
                got, wall = run(name, spec)
                if got != spec["want"]:
                    raise AssertionError(
                        f"native_baseline {name}: the {side} result "
                        "differs from the main phase's torch result")
                walls[side].append(wall)
                if side == "cpp":
                    spec["cpp"] = got
        _torch_run.last_engine = None
        print("native_baseline", json.dumps(dict(
            deployment=name, cpp_s=walls["cpp"],
            torch_warm_s=walls["torch"],
            main_phase_warm_s=spec["torch_warm_s"],
            cpp_over_torch=min(walls["cpp"]) / min(walls["torch"]),
            identical=True, cpu_model=model, cpu_count=cores)), flush=True)

    _truth, reads = generate_test(4, 1000, 16, 0.02, seed=1)
    _t1, _t2, dual_reads = _small_dual(61, 0.02, n=8, length=1000,
                                       snps=((300, 1), (700, 2)))
    out = {}
    for engine, rd, key in (
            (ConsensusDWFA, reads, lambda r: [(c.sequence, list(c.scores))
                                              for c in r]),
            (DualConsensusDWFA, dual_reads, _dual_key)):
        got = []
        for be in ("native", "torch"):
            eng = engine(CdwfaConfigBuilder().backend(be).device("cuda")
                         .min_count(4).build())
            for r in rd:
                eng.add_sequence(r)
            got.append(key(eng.consensus()))
        if got[0] != got[1]:
            raise AssertionError(f"native_baseline: {engine.__name__} on "
                                 "native and torch differ")
        out[engine.__name__] = len(got[0])
    print("native_engines", json.dumps(dict(
        draws="16 x 1 kb at 2 %", results=out, identical=True)), flush=True)


# ---------------------------------------------------------------------
# phases 15-17: the planners' refusals and the frontier gang


def _alphabet_draw(A, n, length, err, seed, snps=()):
    """``n`` reads over ``A`` symbols, every symbol in the truth (its
    first ``A`` bases are a permutation of them); with ``snps`` (position,
    shift) pairs, the second half of the reads come from a second
    haplotype.  Returns ``(truth, h2 or None, reads)``."""
    import numpy as np
    from waffle_con_tpu_torch.utils.example_gen import corrupt

    rng = np.random.default_rng(seed)
    truth = np.concatenate([
        rng.permutation(A), rng.integers(0, A, size=length - A),
    ]).astype(np.uint8).tobytes()
    h2 = None
    if snps:
        arr = bytearray(truth)
        for pos, shift in snps:
            arr[pos] = (arr[pos] + shift) % A
        h2 = bytes(arr)
    reads = [corrupt(h2 if h2 is not None and i >= n // 2 else truth, err,
                     rng, A) for i in range(n)]
    return truth, h2, reads


def phase_plan_gate():
    """Shapes the arena's planner refuses leave the arena not engaged: a
    single draw of 8 reads over 129 symbols, half of them from a haplotype
    2 SNPs away, and a dual draw of 256 reads over 256 symbols (the arena
    takes at most 128 symbols) on ``cuda``, each equal to the ``"python"``
    oracle and to the C++ engine.  The arena's refusals must have moved,
    the run kernels' planners must have taken every shape (the dual one
    R=256 at A=256 on fewer warps), every run must have launched its
    kernel and no plain twin may run."""
    from waffle_con_tpu_torch import (
        CdwfaConfigBuilder, ConsensusDWFA, DualConsensusDWFA, native)
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
    from waffle_con_tpu_torch.ops import run_kernel as rk

    cases = [
        # two haplotypes, so the search branches and the arena has
        # competitors to take
        ("single_A129", ConsensusDWFA,
         _alphabet_draw(129, 8, 600, 0.01, 3, snps=((200, 1), (400, 5))),
         3, "plan_refused_arena"),
        ("dual_A256_R256", DualConsensusDWFA,
         _alphabet_draw(256, 256, 320, 0.01, 5, snps=((110, 1), (220, 7))),
         32, "plan_refused_arena"),
    ]
    for label, engine, (truth, h2, reads), mc, must in cases:
        key = _dual_key if engine is DualConsensusDWFA else (
            lambda r: [(c.sequence, list(c.scores)) for c in r])
        got, counters, walls = {}, None, {}
        for be in ("python", "torch"):
            eng = engine(CdwfaConfigBuilder().backend(be).device("cuda")
                         .min_count(mc).build())
            for r in reads:
                eng.add_sequence(r)
            reset_arena_counts()
            rk.run_extend_cuda.launches = rk.run_extend_plain.calls = 0
            rdk.run_extend_dual_cuda.launches = 0
            rdk.run_extend_dual_plain.calls = 0
            t0 = time.perf_counter()
            got[be] = key(eng.consensus())
            walls[be] = round(time.perf_counter() - t0, 3)
            if be == "torch":
                counters = eng.last_search_stats["scorer_counters"]
                plain = (arena_counts()[1] + rk.run_extend_plain.calls
                         + rdk.run_extend_dual_plain.calls)
                launches = dict(
                    run=rk.run_extend_cuda.launches,
                    run_dual=rdk.run_extend_dual_cuda.launches,
                    arena=arena_counts()[0], gang=gang_launches(),
                    branch_step=branch_launches()[0])
                BRANCH_LAUNCHES["plan_gate"] = (
                    BRANCH_LAUNCHES.get("plan_gate", 0)
                    + launches["branch_step"])
        cfg = CdwfaConfigBuilder().min_count(mc).build()
        t0 = time.perf_counter()
        if engine is DualConsensusDWFA:
            got["cpp"] = _dual_key(native.native_dual_consensus(
                reads, config=cfg))
        else:
            got["cpp"] = [(s, list(sc)) for s, sc in native.native_consensus(
                reads, None, cfg)]
        walls["cpp"] = round(time.perf_counter() - t0, 3)
        refused = {k: counters.get(k, 0) for k in PLAN_KEYS}
        line = dict(case=label, reads=len(reads),
                    symbols=len(set(b"".join(reads))), walls_s=walls,
                    identical=got["torch"] == got["python"] == got["cpp"],
                    **refused, run_calls=counters["run_calls"],
                    run_dual_calls=counters["run_dual_calls"],
                    arena_calls=counters.get("arena_calls", 0),
                    push_calls=counters["push_calls"],
                    clone_push_calls=counters["clone_push_calls"],
                    kernel_launches=launches, **gang_counters(counters),
                    plain_calls=plain,
                    dual_kernel_plan=(
                        _dual_plan_fields(rdk.run_extend_dual_cuda.last_plan)
                        if launches["run_dual"] else None))
        print("plan_gate", json.dumps(line), flush=True)
        if not line["identical"]:
            raise AssertionError(f"plan_gate {label}: torch, python and C++ "
                                 "results differ")
        if refused[must] <= 0 or plain:
            raise AssertionError(f"plan_gate {label}: {must} did not move, "
                                 f"or a plain twin ran ({plain})")
        ran = (launches["run"] + launches["run_dual"],
               kernel_runs(counters) + counters["run_dual_calls"])
        if (refused["plan_refused_run"] or refused["plan_refused_run_dual"]
                or ran[0] != ran[1] or ran[0] <= 0):
            raise AssertionError(f"plan_gate {label}: the run kernels' "
                                 f"planners refused, or launches {ran[0]} != "
                                 f"runs {ran[1]}")
        if launches["gang"] != counters.get("gang_groups", 0):
            raise AssertionError(f"plan_gate {label}: gang launches "
                                 f"{launches['gang']}, counted "
                                 f"{counters.get('gang_groups', 0)}")
        if (engine is DualConsensusDWFA) != (launches["run_dual"] > 0):
            raise AssertionError(f"plan_gate {label}: dual kernel launches "
                                 f"{launches['run_dual']}")
        if engine is DualConsensusDWFA and {
                got["torch"][0][0][0], got["torch"][0][1][0]} != {truth, h2}:
            raise AssertionError(f"plan_gate {label}: haplotypes not "
                                 "recovered")


def gang_bound(R, W, steps):
    """(bound_ms, bound_by) of a gang launch: every member's band read and
    written once and its reads' windows read once (bytes), 20 int32
    operations a band cell a step over all members' steps."""
    nbytes = sum(2 * R * W * 4 + R * (s + W) * 2 for s in steps)
    return bound(nbytes, sum(steps) * R * W * OPS_PER_CELL)


def _gang_compare(R, A, MS, dep_k, dep_p, g):
    """Bitwise comparison of member ``g``'s deposit from two gang runs;
    returns (max_abs_err, RunResult of the first)."""
    from waffle_con_tpu_torch.ops import run_kernel as rk

    ok, op = dep_k["out"][g].cpu().numpy(), dep_p["out"][g].cpu().numpy()
    rk_, rp_ = rk.unpack(ok, R, A, MS), rk.unpack(op, R, A, MS)
    return max(_result_err(rk_, rp_), _rows_err(dep_k, g, dep_p, g)), rk_


def _solo_err(sc, st0, slot, params_g, call, dep, g, R, A, MS):
    """Member ``g`` run alone by the run kernel from the same state and
    arguments (records off): returns (max_abs_err against its deposit,
    the solo launch's ms)."""
    from waffle_con_tpu_torch.ops import run_kernel as rk

    _slot, _len0, me, oc, ol, ms, fs = (int(v) for v in params_g)
    args = rk.RunArgs(me_budget=me, other_cost=oc, other_len=ol,
                      min_count=call.min_count, l2=call.l2, max_steps=ms,
                      first_sym=fs, allow_records=False, wc=call.wc,
                      et=call.et, a_real=A)
    st = _copy_state(st0)
    out, _rs, _rf = rk.run_extend_cuda(st, slot, sc._reads, sc._rlen, args)
    res = rk.unpack(out.cpu().numpy(), R, A, ms)
    dres = rk.unpack(dep["out"][g].cpu().numpy(), R, A, MS)
    err = max(_result_err(res, dres), _rows_err(st, slot, dep, g))
    it = iter([_copy_state(st0) for _ in range(3)])
    solo_ms = _time_cuda(lambda: rk.run_extend_cuda(
        next(it), slot, sc._reads, sc._rlen, args), 3)
    return err, solo_ms


def _wild_reads(make, wc, every=20):
    """Every ``every``-th base of every read replaced by the wildcard."""
    def make2():
        truth, reads = make()
        return truth, [bytes(wc if k % every == every - 1 else b
                             for k, b in enumerate(r)) for r in reads]
    return make2


def gang_kernel_cases(small_only: bool):
    """(label, make-reads, scorer config, call overrides, members) cases.
    A member is ``(prefix_len, first, overrides)``: the branch is the
    truth's first ``prefix_len`` symbols, ``first`` "truth" (forced: the
    truth's next symbol), "wrong" (forced: another symbol) or None
    (unforced), ``overrides`` of the call arguments (``max_steps``,
    ``me_budget``, ``other_cost``, ``other_len``, and ``len0_shift``: a
    consensus length the slot does not hold, so the member must run
    nothing, code -1).  Every case must reach the stop codes named in
    ``want_codes``."""
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    def small(seed, err, n=10, length=120):
        return lambda: generate_test(4, length, n, err, seed=seed)

    ms = dict(max_steps=60)
    cases = [
        ("small/g2", small(1, 0.02), {}, {},
         [(5, "truth", ms), (9, None, ms)], ()),
        ("small/step_cap", small(2, 0.0), {}, {},
         [(3, "truth", dict(max_steps=20)), (4, None, dict(max_steps=25)),
          (6, "wrong", dict(max_steps=30))], (4,)),
        ("small/overflow", _one_random_read(small(5, 0.0)), {}, {},
         [(0, None, dict(max_steps=100)), (2, "truth", dict(max_steps=100))],
         (5,)),
        ("small/l2", small(4, 0.05), dict(allow_early_termination=True),
         dict(l2=True), [(4, "truth", ms), (7, None, ms), (11, None, ms)],
         ()),
        ("small/wildcard", _wild_reads(small(8, 0.02), 9), dict(wildcard=9),
         {}, [(5, "truth", ms), (8, None, ms), (10, "wrong", ms)], ()),
        ("small/lose_pop", small(3, 0.02), {}, {},
         [(5, None, dict(max_steps=60, other_cost=3, other_len=3)),
          (7, "truth", dict(max_steps=60, me_budget=0))], (3,)),
        ("small/desync", small(6, 0.02), {}, {},
         [(4, None, ms), (8, "truth", dict(max_steps=60, len0_shift=1))],
         (-1,)),
    ]
    if small_only:
        return cases
    ns = lambda: generate_test(4, 10000, 256, 0.01, seed=0)  # noqa: E731
    ns_cfg = dict(min_count=64, initial_band=216)
    cap = dict(max_steps=300)
    # 8 branches that each run the whole 300 steps (7 clusters of 16 CTAs
    # fit on the card at once), and a wrong forced symbol (code 1)
    eight = [(20 + 7 * k, ("truth", None)[k % 2], cap) for k in range(8)]
    wrong = [(90, "wrong", cap)]
    cases += [
        ("north_star/g2", ns, ns_cfg, {}, eight[:2], ()),
        ("north_star/g4", ns, ns_cfg, {}, eight[:3] + wrong, (1, 4)),
        ("north_star/g8", ns, ns_cfg, {}, eight, (4,)),
        ("dual_north_star/g4", _dual_north_star_h1,
         dict(min_count=16, initial_band=116), {},
         [(30 + 11 * k, ("truth", None)[k % 2], cap) for k in range(4)], ()),
        ("priority_level1/g4", _priority_level1, PRIORITY_CFG, {},
         [(40 + 9 * k, ("truth", None)[k % 2], cap) for k in range(4)], ()),
        # the kernel phase's cluster/global_band geometry: R=1024, W=514,
        # so each member's band lives in device memory (its rows copied
        # into the deposit, then stepped there with the member's scratch);
        # the last member out of step with its slot
        ("global_band/g4",
         lambda: generate_test(4, 2000, 1024, 0.01, seed=4),
         dict(min_count=256, initial_band=216), {},
         [(20 + 7 * k, ("truth", None)[k % 2], dict(max_steps=100))
          for k in range(3)]
         + [(41, "truth", dict(max_steps=100, len0_shift=1))], (-1,)),
    ]
    return cases


def phase_gang_kernel(small_only: bool):
    """The frontier-gang kernel (``csrc/run_ragged.cu``, one thread-block
    cluster per member) against its plain twin on the card and against a
    solo run-kernel launch of each member from the same state: every
    deposit compared bitwise.  Returns the kernel table's numbers (the
    north star's 8-member launch, or the first case with
    ``small_only``), the max error, and the co-resident clusters of that
    plan."""
    import numpy as np
    import torch
    from waffle_con_tpu_torch.ops import ragged_kernel as rgk

    max_err = 0
    timing = None
    cache = {}
    codes_seen = set()
    for label, make, cfg, call_kw, members, want_codes in gang_kernel_cases(
            small_only):
        if make not in cache:
            cache[make] = make()
        truth, reads = cache[make]
        sc = _scorer(reads, **cfg)
        # the branches: the truth's (distinct) prefixes, each a clone of
        # one root pushed symbol by symbol
        prefixes = [p for p, _f, _o in members]
        assert len(set(prefixes)) == len(prefixes), label
        h = sc.root(np.ones(sc.num_reads, dtype=bool))
        at = {}
        for k in range(max(prefixes) + 1):
            if k in prefixes:
                at[k] = sc.clone(h)
            if k < max(prefixes):
                sc.push(h, truth[: k + 1])
        rows = []
        for p, first, over in members:
            fs = -1
            if first == "truth":
                fs = sc.sym_id[truth[p]]
            elif first == "wrong":
                fs = (sc.sym_id[truth[p]] + 1) % sc.num_symbols
            kw = dict(dict(max_steps=200, me_budget=2**31 - 1,
                           other_cost=2**31 - 1, other_len=0,
                           len0_shift=0), **over)
            rows.append((sc._slot_of[at[p]], p + kw["len0_shift"],
                         kw["me_budget"],
                         kw["other_cost"], kw["other_len"], kw["max_steps"],
                         fs))
        params = np.asarray(rows, dtype=np.int32)
        call = rgk.GangCall(
            min_count=cfg.get("min_count", 3), l2=call_kw.get("l2", False),
            wc=sc._wc, et=sc._et, a_real=sc.num_symbols)
        R, A, W, G = sc._R, sc.num_symbols, sc._W, len(rows)
        MS = int(params[:, 5].max())
        st0 = _copy_state(sc._state)
        dep_k = rgk.run_ragged_cuda(st0, params, sc._reads, sc._rlen, call)
        plan = rgk.run_ragged_cuda.last_plan
        if label.startswith("global_band/") and plan.run.band != "global":
            raise AssertionError(f"{label}: band {plan.run.band}, want the "
                                 "device-memory band")
        held = []
        p_ms = _time_cuda(lambda: held.append(rgk.run_ragged_plain(
            st0, params, sc._reads, sc._rlen, call)), 1)
        dep_p = held[0]
        steps, codes, solo_ms = [], [], 0.0
        for g in range(G):
            if int(dep_k["out"][g, 1]) == -1:
                # out of step with its slot: nothing ran, nothing to hold
                # but the code and the slot's length
                got = dep_k["out"][g, :5].tolist()
                want = dep_p["out"][g, :5].tolist()
                if got != want:
                    raise AssertionError(f"{label} member {g}: {got} vs "
                                         f"{want}")
                steps.append(0)
                codes.append(-1)
                continue
            err, res = _gang_compare(R, A, MS, dep_k, dep_p, g)
            serr, s_ms = _solo_err(sc, st0, int(params[g, 0]), params[g],
                                   call, dep_k, g, R, A, MS)
            solo_ms += s_ms
            max_err = max(max_err, err, serr)
            if err or serr:
                raise AssertionError(
                    f"{label} member {g}: kernel != plain (max err {err}) "
                    f"or != solo launch ({serr})")
            steps.append(res.steps)
            codes.append(res.code)
        codes_seen |= set(codes)
        if not set(want_codes) <= set(codes):
            raise AssertionError(f"{label}: stop codes {codes}, want "
                                 f"{want_codes} among them")
        k_ms = _time_cuda(lambda: rgk.run_ragged_cuda(
            st0, params, sc._reads, sc._rlen, call), 3)
        dev_ms = _launch_device_ms(lambda: rgk.run_ragged_cuda(
            st0, params, sc._reads, sc._rlen, call), 3)
        torch.cuda.synchronize()
        bound_ms, bound_by = gang_bound(R, W, steps)
        longest = max(max(steps), 1)
        line = dict(
            case=label, members=G, reads=R, W=W, A=A, steps=steps,
            codes=codes, cluster=plan.run.cluster,
            ctas_threads=plan.run.threads, band=plan.run.band,
            smem_bytes=plan.run.smem_bytes, **_pack_fields(plan),
            coresident_clusters=rgk.max_clusters(plan),
            kernel_ms=round(k_ms, 4), device_ms=dev_ms,
            kernel_us_per_step=round(1000 * k_ms / longest, 3),
            solo_sum_ms=round(solo_ms, 4), plain_ms=round(p_ms, 3),
            bound_ms=bound_ms, bound_by=bound_by)
        print("gang_kernel", json.dumps(line), flush=True)
        if label == "north_star/g8" or (small_only and timing is None):
            timing = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                          bound_by=bound_by, solo_ms=solo_ms,
                          device_ms=dev_ms, clusters=plan.clusters,
                          waves=plan.waves,
                          coresident_clusters=line["coresident_clusters"])
        del sc, st0, dep_k, dep_p
    if not {4, 5, 3} <= codes_seen:
        raise AssertionError(f"gang_kernel: stop codes {codes_seen}")
    return timing, max_err


def low_coverage_draw():
    """A PGx gene sampled at low depth: 16 reads x 5 kb at 2 %,
    ``min_count=4``."""
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    return generate_test(4, 5000, 16, 0.02, seed=52300)


def _gang_test_draws():
    """The JAX package's frontier-gang test draws (``tests/
    test_frontier_gang.py``): 8 reads x 300 bp at 2 % (single engine,
    ``min_count=2``) and two haplotypes of 5 reads x 250 bp at 4 % (dual
    engine, ``min_count=2``)."""
    import numpy as np
    from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

    _, noisy = generate_test(4, 300, 8, 0.02, seed=52300)
    rng = np.random.default_rng(61250)
    truth, reads1 = generate_test(4, 250, 5, 0.04, seed=61251)
    h2 = bytearray(truth)
    for pos in rng.choice(250, size=3, replace=False):
        h2[pos] = (h2[pos] + 1 + int(rng.integers(3))) % 4
    dual = list(reads1) + [
        corrupt(bytes(h2), 0.04, np.random.default_rng(61252 + i))
        for i in range(5)]
    return noisy, dual


def phase_gang_main():
    """Every deployment the main phases ran, at the default (adaptive)
    frontier width, at ``frontier_width=8`` and at ``frontier_width=1``,
    each byte-equal to the others and to the C++ engine's result
    (``native_baseline``'s, or the C++ engine run here); then the
    low-coverage draw and the JAX package's gang test draws the same way.
    One line per search: the gang counters, the gang kernel's launches,
    the warm wall and the device ms.  Fails when a plain twin ran, when a
    gang launch was not counted as a gang, or when no search of the phase
    launched the gang kernel.  Returns the gang kernel's launches."""
    import dataclasses

    import torch
    from waffle_con_tpu_torch import CdwfaConfigBuilder

    specs = {name: dict(BASELINE[name]) for name in
             ("single", "dual", "priority", "late") if name in BASELINE}
    truth, reads = low_coverage_draw()
    specs["low_coverage"] = dict(
        reads=reads, offsets=None, config=CdwfaConfigBuilder().backend(
            "torch").device("cuda").min_count(4).build())
    noisy, dual = _gang_test_draws()
    specs["gang_test_single"] = dict(
        reads=noisy, offsets=None, config=CdwfaConfigBuilder().backend(
            "torch").device("cuda").min_count(2).build())
    specs["gang_test_dual"] = dict(
        reads=dual, config=CdwfaConfigBuilder().backend("torch")
        .device("cuda").min_count(2).build())
    total = 0
    for name, spec in specs.items():
        kind = ("dual" if name in ("dual", "gang_test_dual") else
                "priority" if name == "priority" else "single")
        cpp = spec.get("cpp")
        if cpp is None:
            cpp, _s = _cpp_run(kind, spec)
        results = {}
        for width in (None, 8, 1):
            run = dict(spec, config=dataclasses.replace(
                spec["config"], frontier_width=width))
            reset_arena_counts()
            got, wall = _torch_run(kind, run)
            launches = gang_launches()
            plain = arena_counts()[1]
            eng = _torch_run.last_engine
            c = eng.last_search_stats["scorer_counters"]
            if plain or launches != c.get("gang_groups", 0):
                raise AssertionError(
                    f"gang_main {name} width {width}: gang launches "
                    f"{launches}, counted {c.get('gang_groups', 0)}, plain "
                    f"calls {plain}")
            total += launches
            results[width] = got
            device_ms = None
            if width != 1:
                device_ms, _by = _device_ms(eng.consensus)
            st = eng.last_search_stats
            print("gang_main", json.dumps(dict(
                deployment=name, frontier_width=width,
                gang_kernel_launches=launches, **gang_counters(c),
                **plan_refusals(f"gang_main {name} width {width}", c),
                run_calls=c["run_calls"], arena_calls=c.get("arena_calls", 0),
                pops=st["nodes_explored"] + st["nodes_ignored"],
                warm_s=round(wall, 4), profiled_device_ms=device_ms,
                equal_to_cpp=got == cpp)), flush=True)
            del eng
            _torch_run.last_engine = None
        if not results[None] == results[8] == results[1] == cpp:
            raise AssertionError(f"gang_main {name}: results differ across "
                                 "frontier widths or from the C++ engine")
    torch.cuda.synchronize()
    if total <= 0:
        raise AssertionError("gang_main: no search launched the gang kernel")
    return total


# ---------------------------------------------------------------------
# phases 18-19: search checkpoints and the observability plane


def reset_launch_counts():
    """Zero every kernel wrapper's launch count and every plain twin's
    call count."""
    from waffle_con_tpu_torch.ops import replay_kernel as rpk
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
    from waffle_con_tpu_torch.ops import run_kernel as rk

    reset_arena_counts()
    rk.run_extend_cuda.launches = 0
    rk.run_extend_plain.calls = 0
    rdk.run_extend_dual_cuda.launches = 0
    rdk.run_extend_dual_plain.calls = 0
    rpk.offset_scan_cuda.launches = 0
    rpk.offset_scan_plain.calls = 0
    rpk.replay_rows_cuda.launches = 0
    rpk.replay_rows_cuda.activate_launches = 0
    rpk.replay_rows_plain.calls = 0


def launch_counts():
    """Launches of each kernel and calls of the plain twins (``plain``)
    since the last :func:`reset_launch_counts`."""
    from waffle_con_tpu_torch.ops import replay_kernel as rpk
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
    from waffle_con_tpu_torch.ops import run_kernel as rk

    arena_launches, arena_plain = arena_counts()
    return dict(
        run_extend=rk.run_extend_cuda.launches,
        run_extend_dual=rdk.run_extend_dual_cuda.launches,
        arena=arena_launches, run_ragged=gang_launches(),
        offset_scan=rpk.offset_scan_cuda.launches,
        col_replay=rpk.replay_rows_cuda.launches,
        col_replay_activate=rpk.replay_rows_cuda.activate_launches,
        branch_step=branch_launches()[0],
        plain=(rk.run_extend_plain.calls + rdk.run_extend_dual_plain.calls
               + rpk.offset_scan_plain.calls + rpk.replay_rows_plain.calls
               + arena_plain),
    )


class RestoreTimer:
    """Times a checkpoint restore on the card, split by scorer call:
    while an engine's ``_restore_search`` runs, ``root``, ``push_many``
    (the column replay), ``activate`` (one column-replay launch a read)
    and ``stats`` of the branch store are timed between two
    ``torch.cuda.synchronize()`` calls, and inside them the branch-step
    advances (``branch_kernel.advance``: the launches and the copy of
    their result, between synchronisations too) and the host's
    conversion of each batch's stats (``_stats_batch``, host work only,
    no synchronisation), so that the replay's host time is its calls'
    time less theirs.  Used as a context manager around a resumed
    search."""

    OPS = ("root", "push_many", "activate", "stats")
    #: (owner, name, synchronise) of the calls timed inside them; the
    #: owner is looked up when the timer is entered
    INNER = (("branch_kernel", "advance", True),
             ("TorchScorer", "_stats_batch", False))

    def __init__(self):
        names = self.OPS + tuple(name for _owner, name, _ in self.INNER)
        self.seconds = {op: 0.0 for op in names}
        self.calls = {op: 0 for op in names}
        self.activate_launches = 0
        self.restore_s = 0.0
        self._active = False
        self._saved = []

    def _timed(self, op, fn, sync=True):
        import torch
        from waffle_con_tpu_torch.ops import replay_kernel as rpk

        timer = self
        settle = torch.cuda.synchronize if sync else (lambda: None)

        def wrapper(*args, **kwargs):
            if not timer._active:
                return fn(*args, **kwargs)
            settle()
            before = rpk.replay_rows_cuda.activate_launches
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            settle()
            timer.seconds[op] += time.perf_counter() - t0
            timer.calls[op] += 1
            timer.activate_launches += (
                rpk.replay_rows_cuda.activate_launches - before)
            return out

        return wrapper

    def _restoring(self, fn):
        import torch

        timer = self

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timer._active = True
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                timer._active = False
                timer.restore_s += time.perf_counter() - t0

        return wrapper

    def __enter__(self):
        from waffle_con_tpu_torch import ConsensusDWFA, DualConsensusDWFA
        from waffle_con_tpu_torch.ops import branch_kernel
        from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer

        owners = dict(branch_kernel=branch_kernel, TorchScorer=TorchScorer)
        for cls, names, wrap in (
                (TorchScorer, self.OPS, self._timed),
                *((owners[owner], (name,),
                   lambda op, fn, sync=sync: self._timed(op, fn, sync))
                  for owner, name, sync in self.INNER),
                (ConsensusDWFA, ("_restore_search",), None),
                (DualConsensusDWFA, ("_restore_search",), None)):
            for name in names:
                fn = cls.__dict__[name]
                self._saved.append((cls, name, fn))
                setattr(cls, name, wrap(name, fn) if wrap is not None
                        else self._restoring(fn))
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        self._saved.clear()
        return False

    def split(self):
        return dict(
            restore_s=round(self.restore_s, 4),
            root_s=round(self.seconds["root"], 4),
            root_calls=self.calls["root"],
            replay_s=round(self.seconds["push_many"], 4),
            push_many_calls=self.calls["push_many"],
            branch_advance_s=round(self.seconds["advance"], 4),
            branch_advance_calls=self.calls["advance"],
            stats_batch_s=round(self.seconds["_stats_batch"], 4),
            stats_batch_calls=self.calls["_stats_batch"],
            activate_s=round(self.seconds["activate"], 4),
            activate_calls=self.calls["activate"],
            col_replay_launches=self.activate_launches,
            stats_s=round(self.seconds["stats"], 4),
            stats_calls=self.calls["stats"],
        )


def _engine_for(kind, spec, config=None):
    """A fed engine of a deployment (``kind``: single, dual or priority)."""
    from waffle_con_tpu_torch import (
        ConsensusDWFA, DualConsensusDWFA, PriorityConsensusDWFA)

    config = config or spec["config"]
    if kind == "priority":
        eng = PriorityConsensusDWFA(config)
        for chain in spec["chains"]:
            eng.add_sequence_chain(chain)
        return eng
    eng = (DualConsensusDWFA if kind == "dual" else ConsensusDWFA)(config)
    _add_reads(eng, zip(spec["reads"],
                        spec.get("offsets") or [None] * len(spec["reads"])))
    return eng


def _result_key(kind, res):
    if kind == "dual":
        return _dual_key(res)
    if kind == "priority":
        return _priority_key(res)
    return [(c.sequence, list(c.scores)) for c in res]


def _preempted(make, at):
    """The checkpoint of ``make()``'s search preempted at poll ``at``."""
    from waffle_con_tpu_torch.models import checkpoint as ck

    ctrl = ck.CheckpointController(snapshot_at_pops={at}, preempt=True)
    try:
        with ck.installed(ctrl):
            make().consensus()
    except ck.SearchPreempted as stop:
        return stop.checkpoint
    raise AssertionError(f"the search was not preempted at poll {at}")


CKPT_LAUNCHES = {}


def phase_checkpoint_main():
    """Every tracked deployment the main phases ran, snapshotted half way
    and resumed on ``cuda``: an uninterrupted search gives the poll count
    (a ``CheckpointController`` that never snapshots), a second one is
    preempted at half the polls (``SearchPreempted``), its checkpoint goes
    through ``to_json`` / ``from_json`` and resumes on ``cuda``.  The
    resumed result must equal the uninterrupted one and the C++ engine's,
    byte for byte.  One line per deployment: checkpoint bytes, restored
    nodes, the restore's seconds split into root, replay (``push_many``
    calls) and activate (column-replay launches), the resumed search's
    wall and its launches by kernel, and the planners' refusals (must be
    0).  Then a ``"python"`` checkpoint of a small dual draw resumes on
    ``cuda`` to the same result, and a tampered checkpoint is refused.
    Returns the resumed searches' launches by kernel."""
    import json as _json

    import torch
    from waffle_con_tpu_torch.models import checkpoint as ck

    if not BASELINE:
        raise AssertionError("checkpoint_main needs main, dual_main, "
                             "priority_main or late_main before it")
    totals = {}
    for name in ("single", "dual", "priority", "late"):
        spec = BASELINE.get(name)
        if spec is None:
            continue
        kind = name if name in ("dual", "priority") else "single"
        cpp = spec.get("cpp")
        if cpp is None:
            cpp, _s = _cpp_run(name, spec)
        ctrl = ck.CheckpointController()
        eng = _engine_for(kind, spec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ck.installed(ctrl):
            got = _result_key(kind, eng.consensus())
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        if got != spec["want"] or got != cpp:
            raise AssertionError(f"checkpoint_main {name}: the uninterrupted "
                                 "search differs from the main phase's")
        polls = ctrl.polls
        at = polls // 2
        checkpoint = _preempted(lambda: _engine_for(kind, spec), at)
        text = checkpoint.to_json()
        state = checkpoint.body["state"]
        nodes = len((state["inner"] if kind == "priority" else state)
                    ["entries"])
        resumed = ck.resume_engine(ck.SearchCheckpoint.from_json(text))
        reset_launch_counts()
        with RestoreTimer() as timer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = resumed.consensus()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = launch_counts()
        c = resumed.last_search_stats["scorer_counters"]
        refused = plan_refusals(f"checkpoint_main {name}", c)
        got = _result_key(kind, res)
        if got != spec["want"] or got != cpp:
            raise AssertionError(f"checkpoint_main {name}: the resumed "
                                 "search differs from the uninterrupted one "
                                 "or from the C++ engine")
        if launches["plain"]:
            raise AssertionError(f"checkpoint_main {name}: a plain twin ran "
                                 f"{launches}")
        # an activation that overflows the band commits nothing, grows it
        # and launches again: at least one launch an activation
        if timer.activate_launches < timer.calls["activate"]:
            raise AssertionError(f"checkpoint_main {name}: {timer.calls} "
                                 "activations but "
                                 f"{timer.activate_launches} launches")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        print("checkpoint_main", _json.dumps(dict(
            deployment=name, polls=polls, preempted_at_poll=at,
            pops_at_checkpoint=int((state["inner"] if kind == "priority"
                                    else state)["pops"]),
            checkpoint_bytes=len(text.encode("utf-8")),
            restored_nodes=nodes,
            consensus_bases=sum(
                len(ck.unb64(e[k])) for e in (
                    state["inner"] if kind == "priority" else state)
                ["entries"]
                for k in ("consensus", "consensus1", "consensus2")
                if k in e),
            **timer.split(), resumed_wall_s=round(wall, 4),
            grow_e_events=c.get("grow_e_events", 0),
            uninterrupted_s=round(full_s, 4), kernel_launches=launches,
            **refused, identical_to_uninterrupted=True,
            identical_to_cpp=True,
        )), flush=True)

    # a checkpoint of the python oracle resumes on the branch store
    from waffle_con_tpu_torch import CdwfaConfigBuilder, DualConsensusDWFA

    _t1, _t2, reads = _small_dual(31, 0.02)

    def small(backend):
        eng = DualConsensusDWFA(CdwfaConfigBuilder().backend(backend)
                                .device("cuda").min_count(3).build())
        for r in reads:
            eng.add_sequence(r)
        return eng

    want = _dual_key(small("python").consensus())
    ctrl = ck.CheckpointController()
    with ck.installed(ctrl):
        small("python").consensus()
    checkpoint = _preempted(lambda: small("python"), ctrl.polls // 2)
    body = _json.loads(_json.dumps(checkpoint.body))
    body["config"]["backend"] = "torch"
    body["config"]["device"] = "cuda"
    moved = ck.SearchCheckpoint("dual", body)
    got = _dual_key(ck.resume_engine(
        ck.SearchCheckpoint.from_json(moved.to_json())).consensus())
    if got != want or _dual_key(small("torch").consensus()) != want:
        raise AssertionError("checkpoint_main: a python checkpoint resumed "
                             "on cuda differs from the python search")
    # a tampered body fails its CRC; a corrupted read behind a valid CRC
    # fails the restored nodes' priority check on the card
    wire = _json.loads(moved.to_json())
    wire["body"]["state"]["pops"] += 1
    rejected = []
    try:
        ck.SearchCheckpoint.from_wire(wire)
    except ck.CheckpointRejected as exc:
        rejected.append(str(exc))
    bad = _json.loads(_json.dumps(body))
    bad["reads"] = [ck.b64(bytes((b + 1) % 4 for b in ck.unb64(r)))
                    for r in bad["reads"]]
    try:
        ck.resume_engine(ck.SearchCheckpoint("dual", bad)).consensus()
    except ck.CheckpointRejected as exc:
        rejected.append(str(exc))
    if len(rejected) != 2:
        raise AssertionError(f"checkpoint_main: tampered checkpoints not "
                             f"refused ({rejected})")
    print("checkpoint_checks", _json.dumps(dict(
        python_checkpoint_polls=ctrl.polls,
        python_resumed_on_cuda_identical=True, rejected=rejected)),
        flush=True)
    CKPT_LAUNCHES.update(totals)
    return totals


def _launches_enclosed(prof):
    """Kernel launches in a ``torch.profiler`` trace (the runtime's
    ``cudaLaunchKernel*`` calls) and how many lie inside a ``search`` and
    inside a ``dispatch:*`` ``record_function`` range (the search runs on
    one thread, so ranges and launches are matched by time alone; the
    ranges' copies on the device's timeline are left out)."""
    import bisect

    from torch.autograd import DeviceType

    ranges = {"search": [], "dispatch": []}
    launches = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        tr = e.time_range
        if e.name == "search":
            ranges["search"].append((tr.start, tr.end))
        elif e.name.startswith("dispatch:"):
            ranges["dispatch"].append((tr.start, tr.end))
        elif e.name.startswith("cudaLaunchKernel"):
            launches.append((tr.start, tr.end))
    dispatch_ranges = len(ranges["dispatch"])
    for kind, spans in ranges.items():
        # nested ranges (a priority search's inner dual searches) merge
        # into the one that encloses them
        merged = []
        for start, end in sorted(spans):
            if merged and start <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], end))
            else:
                merged.append((start, end))
        ranges[kind] = merged

    def inside(kind, start, end):
        spans = ranges[kind]
        i = bisect.bisect_right(spans, (start, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= start and end <= spans[i][1]

    return dict(
        kernel_launches=len(launches),
        in_search_range=sum(inside("search", *ln) for ln in launches),
        in_dispatch_range=sum(inside("dispatch", *ln) for ln in launches),
        dispatch_ranges=dispatch_ranges,
    )


def phase_obs_main():
    """The dual and priority north stars warm with the observability plane
    on (metrics, the tracer with its ``torch.profiler`` bridge, an audit
    capture) and off, alternating (off, on, on, off): results and every
    kernel's launch count must be identical; one line per search with
    its wall, and for the plane on the Chrome trace's span count, metric
    series and audit records.  One more search with the plane on runs
    under ``torch.profiler``: the kernel launches inside a ``search`` and
    inside a ``dispatch:*`` ``record_function`` range.  Then a small dual
    draw: the audit log of the ``cuda`` search (strict alignment: no
    arena) ``diff_logs`` identical to the ``"python"`` search's, the
    lockstep shadow on it clean, and a
    seeded ``flip_vote`` on a small single draw aborts the shadow exactly
    once."""
    import contextlib
    import json as _json

    import torch
    from torch.profiler import ProfilerActivity, profile
    from waffle_con_tpu_torch import (
        CdwfaConfigBuilder, ConsensusDWFA, DualConsensusDWFA)
    from waffle_con_tpu_torch.obs import audit as obs_audit
    from waffle_con_tpu_torch.obs import metrics as obs_metrics
    from waffle_con_tpu_torch.obs import trace as obs_trace
    from waffle_con_tpu_torch.runtime import faults
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    tracer = obs_trace.get_tracer()

    def plane(on):
        obs_metrics.enable_metrics(on)
        obs_metrics.registry().reset()
        tracer.enable(on)
        tracer.enable_profiler_bridge(on)
        tracer.clear()

    def search(kind, spec, on):
        plane(on)
        try:
            eng = _engine_for(kind, spec)
            reset_launch_counts()
            records = 0
            with (obs_audit.capture() if on
                  else contextlib.nullcontext([])) as sinks:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = _result_key(kind, eng.consensus())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                records = sum(len(s.records) for s in sinks)
            spans = len(tracer.chrome_events())
            series = sum(len(f["series"]) for f in
                         obs_metrics.registry().snapshot().values())
            return got, wall, launch_counts(), spans, series, records, eng
        finally:
            plane(False)

    for name in ("dual", "priority"):
        spec = BASELINE.get(name)
        if spec is None:
            continue
        walls = {"off": [], "on": []}
        counts = []
        for on in (False, True, True, False):
            got, wall, launches, spans, series, records, eng = search(
                name, spec, on)
            plan_refusals(f"obs_main {name}",
                          eng.last_search_stats["scorer_counters"])
            if got != spec["want"]:
                raise AssertionError(f"obs_main {name}: the result with the "
                                     f"plane {'on' if on else 'off'} differs")
            counts.append(launches)
            walls["on" if on else "off"].append(round(wall, 4))
            print("obs_search", _json.dumps(dict(
                deployment=name, plane="on" if on else "off",
                wall_s=round(wall, 4), kernel_launches=launches,
                chrome_spans=spans, metric_series=series,
                audit_records=records)), flush=True)
        if any(c != counts[0] for c in counts) or counts[0]["plain"]:
            raise AssertionError(f"obs_main {name}: launch counts differ "
                                 f"with the plane on and off: {counts}")
        plane(True)
        try:
            eng = _engine_for(name, spec)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.consensus()
                torch.cuda.synchronize()
        finally:
            plane(False)
        enclosed = _launches_enclosed(prof)
        if (not enclosed["kernel_launches"]
                or enclosed["in_search_range"] != enclosed["kernel_launches"]):
            raise AssertionError(f"obs_main {name}: kernel launches outside "
                                 f"the search range {enclosed}")
        print("obs_main", _json.dumps(dict(
            deployment=name, wall_off_s=walls["off"], wall_on_s=walls["on"],
            on_over_off=round(min(walls["on"]) / min(walls["off"]), 4),
            identical_results=True, identical_launches=True,
            profiler=enclosed)), flush=True)

    # the audit plane on a small dual draw and a small single draw
    _t1, _t2, reads = _small_dual(47, 0.02)

    def small(engine, backend, rd, min_count):
        eng = engine(CdwfaConfigBuilder().backend(backend).device("cuda")
                     .min_count(min_count).build())
        for r in rd:
            eng.add_sequence(r)
        return eng

    # strict alignment keeps the cuda search off the arena, so each of
    # its pops is a decision the python log holds too
    with obs_audit.capture(strict_align=True) as sinks:
        small(DualConsensusDWFA, "torch", reads, 3).consensus()
        small(DualConsensusDWFA, "python", reads, 3).consensus()
    cuda_log, py_log = sinks[0].records, sinks[1].records
    if (obs_audit.diff_logs(cuda_log, py_log) is not None
            or obs_audit.diff_logs(py_log, cuda_log) is not None):
        raise AssertionError("obs_main: the cuda and python audit logs "
                             "diverge")
    keys = [{key for rec in log for key, _v in obs_audit.expand_units(rec)}
            for log in (cuda_log, py_log)]
    obs_audit.reset_stats()
    with obs_audit.shadow_override("python"):
        small(DualConsensusDWFA, "torch", reads, 3).consensus()
    clean = obs_audit.stats_snapshot()
    if clean["divergences"] or not clean["shadow_pops"]:
        raise AssertionError(f"obs_main: the shadow is not clean {clean}")
    _truth, single_reads = generate_test(4, 300, 8, 0.02, seed=19)
    with obs_audit.capture(strict_align=True) as sinks:
        small(ConsensusDWFA, "torch", single_reads, 2).consensus()
    forced = [r for r in sinks[0].records
              if r["kind"] == "run" and r.get("forced")]
    if not forced:
        raise AssertionError("obs_main: no forced run to flip")
    plan = faults.install(faults.FaultPlan()).add(
        "flip_vote", backend="torch", op="vote", at=forced[0]["len"],
        count=1)
    obs_audit.reset_stats()
    detail = None
    try:
        with obs_audit.shadow_override("python"):
            small(ConsensusDWFA, "torch", single_reads, 2).consensus()
    except obs_audit.ParityDivergence as exc:
        detail = exc.detail
    finally:
        faults.clear()
    flipped = obs_audit.stats_snapshot()
    if (detail is None or flipped["divergences"] != 1
            or plan.specs[0].fired != 1):
        raise AssertionError(f"obs_main: the seeded flip_vote did not abort "
                             f"the shadow once {flipped}")
    print("obs_audit", _json.dumps(dict(
        dual_draw="6 + 6 reads x 140 bp at 2 %, 2 SNPs",
        cuda_records=len(cuda_log), python_records=len(py_log),
        decisions_compared=len(keys[0] & keys[1]),
        diff_logs_identical=True, shadow_clean=clean,
        flip_vote_at_len=forced[0]["len"], flip_divergence_key=detail["key"],
        flip_stats=flipped)), flush=True)


# ---------------------------------------------------------------------
# phase 21: the runtime plane (supervised dispatch)


#: the kernels whose launches a supervised search must match
RUNTIME_KERNELS = ("run_extend", "run_extend_dual", "arena", "branch_step",
                   "offset_scan", "col_replay", "plain")


class _SupervisorWatch:
    """While entered, records each supervised scorer call's ``(op,
    index)`` and the kernel launch counts at each re-promotion (so the
    launches after it can be told apart)."""

    def __enter__(self):
        from waffle_con_tpu_torch.runtime import supervisor

        self.sup = supervisor.BackendSupervisor
        self.saved = (self.sup._supervised, self.sup._probe)
        self.calls, self.at_promotion = [], []
        watch = self
        supervised, probe = self.saved

        def spy(sup, op, involved, call, **kw):
            watch.calls.append((op, sup._dispatch_index))
            return supervised(sup, op, involved, call, **kw)

        def probed(sup):
            before = sup.backend
            probe(sup)
            if sup.backend != before:
                watch.at_promotion.append(launch_counts())

        self.sup._supervised, self.sup._probe = spy, probed
        return self

    def __exit__(self, *exc):
        self.sup._supervised, self.sup._probe = self.saved
        return False


def _supervised_search(name, spec, plan=None, **cfg):
    """One warm search of a deployment through ``_torch_run`` with the
    config's fields replaced by ``cfg`` and ``plan``'s fault rules
    armed; returns ``(result, wall, launches, events, watch, engine)``
    with the event log and the launch counts of that search alone."""
    import dataclasses

    from waffle_con_tpu_torch.runtime import events, faults, supervisor

    run_spec = dict(spec, config=dataclasses.replace(spec["config"], **cfg))
    events.clear_events()
    faults.install(plan) if plan is not None else faults.clear()
    reset_launch_counts()
    try:
        with _SupervisorWatch() as watch:
            got, wall = _torch_run(name, run_spec)
    finally:
        faults.clear()
        supervisor.shutdown_executors(wait=True)
    eng = _torch_run.last_engine
    _torch_run.last_engine = None
    return got, wall, launch_counts(), events.get_events(), watch, eng


def _kinds(evs):
    out = {}
    for e in evs:
        out[e["kind"]] = out.get(e["kind"], 0) + 1
    return out


def _demoted(evs):
    return [(e["from_backend"], e["to_backend"]) for e in evs
            if e["kind"] == "backend_demoted"]


def _mid_call(watch, ops=("run",)):
    """The dispatch index of the middle call of ``ops`` (``arena`` when
    the search made fewer than two of them)."""
    hits = [i for op, i in watch.calls if op in ops]
    if len(hits) < 2:
        hits = [i for op, i in watch.calls if op == "arena"] or hits
    if not hits:
        raise AssertionError(f"runtime_main: no {ops} call to fault")
    return hits[len(hits) // 2]


def phase_runtime_main():
    """The runtime plane (``waffle_con_tpu_torch/runtime``) on the single,
    dual and priority north stars the main phases ran, on ``cuda``:

    * supervised without a fault: the result equals the unsupervised
      search's and the C++ engine's byte for byte, no demotion, and every
      kernel's launches equal the unsupervised search's; the warm walls of
      both, alternating (unsupervised, supervised, supervised,
      unsupervised), side by side; one more supervised search with the
      dispatch timer on (every call on the supervisor's worker thread);
    * ``device_loss`` at the middle ``"torch"`` run call (and its two
      retries): one demotion torch -> native, byte-identical;
    * ``garbage`` once and ``timeout`` once at that call: caught and
      retried without a demotion, byte-identical;
    * ``repromote_after`` (single and priority): after that demotion the
      search returns to ``"torch"`` and launches kernels there,
      byte-identical;
    * the dispatch budget pinned at the search's own count passes in
      strict mode, one fewer raises;

    then on the single north star ``pallas_compile`` armed raises
    unsupervised and demotes supervised (an event), and on a small draw
    the chain torch -> python (demotion to the oracle).  Each line
    carries the card's name and power limit."""
    from waffle_con_tpu_torch import CdwfaConfigBuilder, ConsensusDWFA
    from waffle_con_tpu_torch.runtime import faults, watchdog
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    smi = smi_line()
    ran = [n for n in ("single", "dual", "priority") if n in BASELINE]
    if not ran:
        raise AssertionError("runtime_main needs main, dual_main or "
                             "priority_main before it")

    def emit(kind, **line):
        print("runtime_main", json.dumps(dict(case=kind, card=smi, **line)),
              flush=True)

    def check(name, tag, got, spec, evs, demotions=()):
        cpp = spec.get("cpp")
        if cpp is None:
            cpp = spec["cpp"] = _cpp_run(name, spec)[0]
        if got != spec["want"] or got != cpp:
            raise AssertionError(f"runtime_main {name} {tag}: the result "
                                 "differs from the unsupervised / C++ one")
        if _demoted(evs) != list(demotions):
            raise AssertionError(f"runtime_main {name} {tag}: demotions "
                                 f"{_demoted(evs)}, expected {demotions}")

    base = dict(retry_backoff_s=0.0)
    for name in ran:
        spec = BASELINE[name]
        # -- no fault: equal results, launches and no demotion
        walls = {"unsupervised": [], "supervised": []}
        counts = {}
        watch = None
        for sup in (False, True, True, False):
            got, wall, launches, evs, w, eng = _supervised_search(
                name, spec, supervised=sup, **base)
            tag = "supervised" if sup else "unsupervised"
            check(name, tag, got, spec, evs)
            plan_refusals(f"runtime_main {name}",
                          eng.last_search_stats["scorer_counters"])
            walls[tag].append(round(wall, 4))
            key = {k: launches[k] for k in RUNTIME_KERNELS}
            if counts.setdefault(tag, key) != key:
                raise AssertionError(f"runtime_main {name}: {tag} launches "
                                     f"differ between runs")
            if sup:
                watch = w
                pinned = watchdog.dispatch_total(
                    eng.last_search_stats["scorer_counters"])
        if counts["supervised"] != counts["unsupervised"] or counts[
                "supervised"]["plain"]:
            raise AssertionError(f"runtime_main {name}: launches differ "
                                 f"{counts}")
        got, wall_t, _l, evs, _w, _e = _supervised_search(
            name, spec, supervised=True, dispatch_timeout_s=600.0, **base)
        check(name, "timer", got, spec, evs)
        emit("no_fault", deployment=name, wall_unsupervised_s=walls[
            "unsupervised"], wall_supervised_s=walls["supervised"],
            supervised_over_unsupervised=round(
                min(walls["supervised"]) / min(walls["unsupervised"]), 4),
            wall_supervised_timer_s=round(wall_t, 4),
            launches=counts["supervised"], demotions=0,
            supervised_calls=len(watch.calls))

        at = _mid_call(watch)
        # -- device loss at the middle run call and its retries
        plan = faults.FaultPlan()
        for k in range(3):
            plan.add("device_loss", backend="torch", at=at + k, count=None)
        got, wall, launches, evs, w, eng = _supervised_search(
            name, spec, plan, supervised=True, **base)
        check(name, "device_loss", got, spec, evs, [("torch", "native")])
        if _kinds(evs).get("dispatch_failed") != 3:
            raise AssertionError(f"runtime_main {name} device_loss: "
                                 f"{_kinds(evs)}")
        emit("device_loss", deployment=name, at_dispatch=at,
             wall_s=round(wall, 4), events=_kinds(evs),
             launches_before_demotion={k: launches[k]
                                       for k in RUNTIME_KERNELS},
             ended_on=eng.last_search_stats["backend"])
        # -- garbage and timeout once: retried, no demotion
        for kind in ("garbage", "timeout"):
            plan = faults.FaultPlan().add(kind, backend="torch", at=at,
                                          count=1)
            got, wall, launches, evs, w, eng = _supervised_search(
                name, spec, plan, supervised=True, **base)
            check(name, kind, got, spec, evs)
            failed = [e for e in evs if e["kind"] == "dispatch_failed"]
            want_err = "GarbageStats" if kind == "garbage" else "Timeout"
            if len(failed) != 1 or want_err not in failed[0]["error"]:
                raise AssertionError(f"runtime_main {name} {kind}: "
                                     f"{failed}")
            emit(kind, deployment=name, at_dispatch=at,
                 wall_s=round(wall, 4), events=_kinds(evs),
                 launches={k: launches[k] for k in RUNTIME_KERNELS})
        # -- re-promotion after the demotion (the single and priority
        # north stars: the dual's migration back replays two 5 kb
        # branches, ~25 s of the script for nothing the others do not show)
        if name != "dual":
            plan = faults.FaultPlan()
            for k in range(3):
                plan.add("device_loss", backend="torch", at=at + k, count=None)
            got, wall, launches, evs, w, eng = _supervised_search(
                name, spec, plan, supervised=True, repromote_after=2, **base)
            check(name, "repromote", got, spec, evs, [("torch", "native")])
            promoted = [e for e in evs if e["kind"] == "backend_promoted"]
            if (not promoted or not w.at_promotion
                    or _kinds(evs).get("dispatch_failed") != 3):
                raise AssertionError(f"runtime_main {name}: no re-promotion "
                                     f"{_kinds(evs)}")
            snap = w.at_promotion[0]
            after = {k: launches[k] - snap[k] for k in RUNTIME_KERNELS}
            kernels_after = sum(v for k, v in after.items() if k != "plain")
            if kernels_after <= 0 or launches["plain"]:
                raise AssertionError(f"runtime_main {name}: launches after the "
                                     f"re-promotion {after}")
            emit("repromote", deployment=name, at_dispatch=at,
                 wall_s=round(wall, 4), events=_kinds(evs),
                 promoted_to=promoted[0]["to_backend"],
                 launches_at_promotion={k: snap[k] for k in RUNTIME_KERNELS},
                 launches_after_promotion=after)
        # -- the dispatch budget
        for sup in (False, True):
            got, wall, _l, evs, _w, eng = _supervised_search(
                name, spec, supervised=sup, dispatch_budget=pinned,
                watchdog_strict=True, **base)
            check(name, "budget", got, spec, evs)
        try:
            _supervised_search(name, spec, dispatch_budget=pinned - 1,
                               watchdog_strict=True)
        except watchdog.WatchdogError:
            pass
        else:
            raise AssertionError(f"runtime_main {name}: strict mode passed "
                                 f"a budget of {pinned - 1}")
        emit("budget", deployment=name, pinned=pinned,
             strict_passes_at_pin=True, strict_raises_below=True)

    # -- a kernel that fails: raises unsupervised, demotes supervised
    name = "single" if "single" in BASELINE else ran[0]
    spec = BASELINE[name]
    plan = faults.FaultPlan().add("pallas_compile", count=None)
    try:
        _supervised_search(name, spec, plan)
    except faults.InjectedKernelFailure as exc:
        raised = repr(exc)
    else:
        raise AssertionError("runtime_main: an armed kernel fault did not "
                             "raise unsupervised")
    plan = faults.FaultPlan().add("pallas_compile", count=None)
    got, wall, launches, evs, _w, eng = _supervised_search(
        name, spec, plan, supervised=True, **base)
    check(name, "pallas_compile", got, spec, evs, [("torch", "native")])
    if sum(launches[k] for k in RUNTIME_KERNELS):
        raise AssertionError(f"runtime_main: a kernel or twin ran with the "
                             f"kernel fault armed {launches}")
    emit("pallas_compile", deployment=name, unsupervised_raised=raised,
         supervised_wall_s=round(wall, 4), events=_kinds(evs),
         ended_on=eng.last_search_stats["backend"])

    # -- the chain down to the oracle, on a small draw
    _truth, reads = generate_test(4, 1000, 16, 0.02, seed=3)
    small = dict(reads=reads, offsets=None, config=CdwfaConfigBuilder()
                 .backend("torch").device("cuda").min_count(4).build())
    small["want"] = _torch_run("single", small)[0]
    small["cpp"] = _cpp_run("single", small)[0]
    py = ConsensusDWFA(CdwfaConfigBuilder().backend("python").min_count(4)
                       .build())
    _add_reads(py, zip(reads, [None] * len(reads)))
    if [(c.sequence, list(c.scores)) for c in py.consensus()] != small["want"]:
        raise AssertionError("runtime_main: the python oracle differs")
    plan = faults.FaultPlan()
    for k in range(3):
        plan.add("device_loss", backend="torch", at=2 + k, count=None)
    got, wall, _l, evs, _w, eng = _supervised_search(
        "single", small, plan, backend_chain=("python",), **base)
    check("small", "python_chain", got, small, evs, [("torch", "python")])
    emit("python_chain", draw="16 x 1 kb at 2 %", wall_s=round(wall, 4),
         events=_kinds(evs), ended_on=eng.last_search_stats["backend"])


# ---------------------------------------------------------------------
# phase 20: the branch store's life-cycle calls


def _branch_store(seed, B, R, length, E, clens, A=4, inactive=(), late=(),
                  garbage=()):
    """A branch store on the card for the branch-step cases: ``R`` reads,
    each a 1 % corruption (``corrupt``) of one random truth of ``length``
    symbols over ``A``, slot ``b`` holding the truth up to ``clens[b]``
    (the slots in ``garbage`` random symbols), ``late`` ``(read,
    offset)`` rows anchored at ``offset`` with the read cut there,
    ``inactive`` ``(slot, read)`` rows off (read ``None``: the whole
    slot); bands and folds from the column-replay kernel.  Returns
    ``(state, reads, rlen)``."""
    import numpy as np
    import torch
    from waffle_con_tpu_torch.ops import replay_kernel as rpk
    from waffle_con_tpu_torch.utils.example_gen import corrupt

    rng = np.random.default_rng(seed)
    truth = rng.integers(0, A, length).astype(np.uint8).tobytes()
    reads = [corrupt(truth, 0.01, rng, A) for _ in range(R)]
    off = np.zeros((B, R), dtype=np.int32)
    for r, o in late:
        reads[r] = reads[r][o:]
        off[:, r] = o
    L = 256
    while L < max(map(len, reads)):
        L *= 2
    rd = np.full((R, L), -1, dtype=np.int16)
    for i, r in enumerate(reads):
        rd[i, :len(r)] = np.frombuffer(r, dtype=np.uint8)
    rlen = np.array([len(r) for r in reads], dtype=np.int32)
    C = max(512, 1 << (length + 64 - 1).bit_length())
    cons = np.zeros((B, C), dtype=np.int32)
    cons[:, :length] = np.frombuffer(truth, dtype=np.uint8)
    for b in garbage:
        cons[b, :length] = rng.integers(0, A, length)
    act = np.ones((B, R), dtype=bool)
    for b, r in inactive:
        act[b, slice(None) if r is None else r] = False
    dev = torch.device("cuda")
    st = dict(off=torch.from_numpy(off).to(dev),
              act=torch.from_numpy(act).to(dev),
              cons=torch.from_numpy(cons).to(dev),
              clen=torch.tensor(list(clens), dtype=torch.int32, device=dev))
    rd, rlen = torch.from_numpy(rd).to(dev), torch.from_numpy(rlen).to(dev)
    D, e, rmin, er = rpk.replay_rows_cuda(
        st["off"], st["act"], st["cons"], st["clen"], rd, rlen, -2, False, E,
        2 * E + 2)
    st.update(D=D, e=e, rmin=rmin, er=er)
    return st, rd, rlen


def branch_bound(entry, state, rows, A):
    """(bound_ms, bound_by) of one branch-step call on ``rows`` (the
    call's own: ``[3, n]`` rows of an advance or a copy, the slots of
    stats and finalize, ``[2, m]`` pairs of a deactivation): each input
    read once and each output written once (the src rows' bands and
    fields read, the dst rows' written, the packed stats written; a copy
    row's consensus read and written, a push row's one symbol), and ~20
    int32 operations a band cell of a pushed active read (4, the tip
    test, a cell of any other active read whose votes are taken)."""
    B, R, W = state["D"].shape
    C = state["cons"].shape[1]
    if entry == "root":
        return bound(4 * R * (W + 6), 0)
    if entry == "deactivate":
        return bound(rows.shape[1] * 9, 0)
    act = state["act"].cpu().numpy()
    if entry in ("stats", "finalize"):
        n, votes = len(rows), entry == "stats"
        head = 4 * (4 * n * R + n + 1)
        if not votes:
            return bound(4 * n * R * 3 + head, 0)
        return bound(4 * n * R * (W + 3 + A) + head,
                     4 * W * int(act[rows].sum()))
    src, dst, sym = rows
    n = rows.shape[1]
    head = 4 * (4 * n * R + n + 1)
    pushed = int(act[src[sym >= 0]].sum())
    others = int(act[src].sum()) - pushed
    copies = int((src != dst).sum())
    votes = 4 * n * R * A + head if entry == "advance" else 0
    nbytes = (2 * 4 * n * R * (W + 5) + 2 * 4 * C * copies
              + 8 * (n - copies) + votes)
    return bound(nbytes, OPS_PER_CELL * W * pushed + 4 * W * others * (
        entry == "advance"))


def _branch_diff(out_k, out_p, st_k, st_p):
    """Where the kernel's call and the twin's differ: ``{field: (max abs
    difference, first index, kernel value, twin value)}`` over the
    outputs (a ``BranchOut`` or a tuple of arrays, ``None`` for none) and
    every store field."""
    import numpy as np

    pairs = [(f"store.{k}", st_k[k].cpu().numpy(), st_p[k].cpu().numpy())
             for k in st_k]
    if out_k is not None:
        names = getattr(out_k, "_fields", range(len(out_k)))
        pairs += [(f"out.{name}", x, y)
                  for name, x, y in zip(names, out_k, out_p)]
    diff = {}
    for name, x, y in pairs:
        x, y = np.asarray(x), np.asarray(y)
        if x.shape != y.shape:
            diff[name] = ("shape", x.shape, y.shape)
            continue
        d = np.abs(x.astype(np.int64) - y.astype(np.int64))
        if d.size and d.max():
            at = np.unravel_index(int(d.argmax()), d.shape)
            diff[name] = (int(d.max()), [int(i) for i in at],
                          x[at].item(), y[at].item())
    return diff


def _branch_call(entry, kernel, st, rd, rl, rows, A, wc, et, bufs=None):
    """One call of ``entry`` on store ``st`` through the CUDA wrapper
    (``kernel``, with the store's persistent buffers ``bufs``) or the
    twin."""
    from waffle_con_tpu_torch.ops import branch_kernel as bk

    if entry in ("advance", "copy"):
        if not kernel:
            return bk.advance_plain(st, rows, rd, rl, wc, et, A,
                                    with_stats=entry == "advance")
        return bk.advance_cuda(st, rows, rd, rl, wc, et, A,
                               with_stats=entry == "advance", bufs=bufs)
    if entry == "stats":
        return (bk.stats_cuda(st, rows, rd, rl, A, bufs=bufs) if kernel
                else bk.stats_plain(st, rows, rd, rl, A))
    if entry == "finalize":
        return (bk.finalize_cuda(st, rows, rd, rl, bufs=bufs) if kernel
                else bk.finalize_plain(st, rows))
    if entry == "root":
        if not kernel:
            return bk.root_plain(st, rows[0], rows[1], rl)
        return bk.root_cuda(st, rows[0], rows[1], rl, bufs=bufs)
    if not kernel:
        return bk.deactivate_plain(st, rows)
    return bk.deactivate_cuda(st, rows, bufs=bufs)


class _forced_slab:
    """Force ``branch_kernel``'s planner onto the slab plan (no band in
    registers) while it is entered, so that ``branch_kernel`` can hold and
    time both plans at one shape."""

    def __enter__(self):
        from waffle_con_tpu_torch.ops import branch_kernel as bk

        self.saved = bk.CELLS
        bk.CELLS = ()
        return self

    def __exit__(self, *exc):
        from waffle_con_tpu_torch.ops import branch_kernel as bk

        bk.CELLS = self.saved
        return False


#: the plan each ``branch_kernel`` case must take (the others print theirs)
BRANCH_PLANS = {
    "north_star/restore_all_active": "one_launch",
    "north_star/restore_none_active": "one_launch",
    "north_star/expand": "one_launch",
    "north_star/copy": "one_launch",
    "north_star/stats": "one_launch",
    "north_star/finalize": "one_launch",
    "wide/W2050": "slab",
    "wide/W139266": "slab",
}
#: entries whose north-star calls must be one launch each
ONE_LAUNCH_ENTRIES = ("advance", "copy", "stats", "finalize")
#: calls of a ``branch_kernel`` case's host-wall loop, and calls on one
#: copy of the case's store before it is restored (a push moves an edit
#: distance by at most one, so no push case reaches its band in 32 calls)
BRANCH_WALL_CALLS = 1000
BRANCH_WALL_CHUNK = 32
#: kernels of ``csrc/branch_step.cu`` (their device time)
BRANCH_KERNELS = ("branch_one_kernel", "branch_rows_kernel",
                  "branch_commit_kernel", "branch_root_kernel",
                  "branch_deactivate_kernel")


def _branch_timing(call, restore, check, reps, walls):
    """The kernel's ms a call (CUDA events around one call, its host work
    included), its host wall a call (``perf_counter`` over ``walls``
    calls, ``BRANCH_WALL_CHUNK`` at a time between synchronisations, the
    store restored before each chunk outside the clock and each chunk's
    last result held to ``check``), and its device ms a call
    (``torch.profiler`` over ``reps`` calls: every device activity, and
    ``csrc/branch_step.cu``'s kernels alone); each measurement starts from
    the case's store (``restore``)."""
    import torch

    restore()
    k_ms = _time_cuda(call, reps)
    wall, done = 0.0, 0
    while done < walls:
        m = min(BRANCH_WALL_CHUNK, walls - done)
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(m):
            out = call()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        check(out)
        done += m
    wall_ms = wall * 1e3 / walls
    restore()
    dev_ms, by_name = _device_ms(lambda: [call() for _ in range(reps)])
    kern_ms = sum(_kernel_ms(by_name, k) for k in BRANCH_KERNELS)
    return dict(
        kernel_ms=round(k_ms, 4), host_wall_ms=round(wall_ms, 4),
        device_ms=None if dev_ms is None else round(dev_ms / reps, 5),
        kernels_device_ms=round(kern_ms / reps, 5))


def branch_case(label, store, entry, rows, A=4, wc=-2, et=False,
                overflow=False, reps=20, variants=()):
    """The kernel and the twin on copies of ``store``, every output and
    every store field compared bitwise (an overflow must leave the store
    as it was), the kernel through one persistent ``BranchBuffers`` as
    ``TorchScorer`` calls it; then its plan, its launches a call, its ms a
    call (CUDA events around it, the host's work and its copy of the
    result included), its host wall a call (1,000 calls, the store
    restored every 32, so a push case commits every call but the overflow
    case's), its device ms (``torch.profiler``: every device activity,
    and the kernels alone), the twin's ms and the bound.  With
    ``variants`` (``("slab",)``: ``_forced_slab``) the slab plan is held
    bitwise and timed the same way.  ``rows``: ``(src, dst, sym)``
    tuples of an advance or a copy, the slots of stats and finalize,
    ``[2, m]`` pairs of a deactivation, ``(slot, act)`` of a root."""
    import numpy as np
    from waffle_con_tpu_torch.ops import branch_kernel as bk

    st0, rd, rl = store
    if entry in ("advance", "copy"):
        rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int32).T)
    elif entry != "root":
        rows = np.asarray(rows, dtype=np.int32)

    def call(kernel, st, bufs=None):
        return _branch_call(entry, kernel, st, rd, rl, rows, A, wc, et, bufs)

    st_p = _copy_state(st0)
    out_p = call(False, st_p)

    def checked(tag):
        """One kernel call on a fresh copy, held to the twin's; returns
        its plan and launches."""
        st_k, bufs = _copy_state(st0), bk.BranchBuffers()
        bk.branch_cuda.last_plan = None
        before = bk.branch_cuda.launches
        out_k = call(True, st_k, bufs)
        launches = bk.branch_cuda.launches - before
        plan = bk.branch_cuda.last_plan
        if (out_k is None) != (out_p is None):
            raise AssertionError(f"{tag}: one side returned no stats")
        diff = _branch_diff(out_k, out_p, st_k, st_p)
        if entry == "advance" and out_k.overflow != overflow:
            raise AssertionError(f"{tag}: overflow {out_k.overflow}, "
                                 f"expected {overflow}")
        if overflow:
            diff.update({f"uncommitted.{k}": v for k, v in _branch_diff(
                None, None, st_k, st0).items()})
        if diff:
            raise AssertionError(f"{tag}: branch_step kernel != plain {diff}")
        return plan, launches

    plan, launches = checked(label)
    want = BRANCH_PLANS.get(label)
    if want is not None and plan.name != want:
        raise AssertionError(f"{label}: plan {plan.name}, expected {want}")
    if (label.startswith("north_star/") and entry in ONE_LAUNCH_ENTRIES
            and launches != 1):
        raise AssertionError(f"{label}: {launches} launches, expected 1")
    st_t = _copy_state(st0)

    def restore():
        for k, v in st0.items():
            st_t[k].copy_(v)

    def check(out):
        if entry == "advance" and out.overflow != overflow:
            raise AssertionError(f"{label}: host-wall call overflow "
                                 f"{out.overflow}, expected {overflow}")

    p_ms = _time_cuda(lambda: call(False, st_t), 3)
    bufs_t = bk.BranchBuffers()
    timing = _branch_timing(lambda: call(True, st_t, bufs_t), restore, check,
                            reps, BRANCH_WALL_CALLS)
    alt = {}
    for variant in variants:
        assert variant == "slab", variant
        with _forced_slab():
            vplan, vlaunches = checked(f"{label}[{variant}]")
            bufs_v = bk.BranchBuffers()
            alt[variant] = dict(
                plan=vplan.name, launches=vlaunches,
                **_branch_timing(lambda: call(True, st_t, bufs_v), restore,
                                 check, reps, BRANCH_WALL_CALLS))
    B, R, W = st0["D"].shape
    bms, by = branch_bound(entry, st0, rows, A)
    line = dict(
        case=label, entry=entry,
        n=1 if entry == "root" else rows.shape[-1], R=R, W=W, A=A,
        overflow=bool(overflow),
        plan=plan._asdict() if plan is not None else None,
        launches_per_call=launches, **timing,
        plain_ms=round(p_ms, 3), bound_ms=bms, bound_by=by, variants=alt)
    print("branch_kernel", json.dumps(line), flush=True)
    return dict(ms=timing["kernel_ms"], plain_ms=p_ms, bound_ms=bms,
                bound_by=by, device_ms=timing["device_ms"],
                host_wall_ms=timing["host_wall_ms"],
                plan=None if plan is None else plan.name), 0


def branch_replay_case(pushes=1000, length=10000):
    """A restore's replay at the single north star's geometry (R=256,
    W=514): a branch rooted with no read active and pushed ``pushes``
    times in place through ``TorchScorer.push_many``, one column a call,
    as ``_replay_consensus`` does, on the card; the same on the CPU
    (the twins) gives the store and the last stats, compared bitwise.
    Prints the wall a ``push_many`` call and the branch step's launches
    and plans."""
    import numpy as np
    import torch
    from waffle_con_tpu_torch import CdwfaConfigBuilder
    from waffle_con_tpu_torch.ops import branch_kernel as bk
    from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    truth, reads = generate_test(4, length, 256, 0.01, seed=0)
    cons = truth[:pushes]
    got = {}
    for device in ("cuda", "cpu"):
        sc = TorchScorer(reads, CdwfaConfigBuilder().backend("torch")
                         .device(device).min_count(64).initial_band(216)
                         .build())
        h = sc.root(np.zeros(len(reads), dtype=bool))
        before = bk.branch_cuda.launches
        entries = dict(bk.branch_cuda.entries)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for col in range(pushes):
            last = sc.push_many([(h, cons[:col + 1])])[0]
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got[device] = dict(
            wall=wall, last=last,
            store={k: v.cpu() for k, v in sc._state.items()},
            launches=bk.branch_cuda.launches - before,
            plans={k: bk.branch_cuda.entries[k] - entries[k]
                   for k in bk.PLANS})
    diff = {k: int((got["cuda"]["store"][k].long()
                    - got["cpu"]["store"][k].long()).abs().max())
            for k in got["cuda"]["store"]}
    a, b = got["cuda"]["last"], got["cpu"]["last"]
    same_stats = all(np.array_equal(x, y) for x, y in (
        (a.eds, b.eds), (a.occ, b.occ), (a.split, b.split),
        (a.reached, b.reached), (a.fin, b.fin)))
    if any(diff.values()) or not same_stats:
        raise AssertionError(f"north_star/replay_1000: kernel != plain "
                             f"{diff}, stats equal {same_stats}")
    line = dict(
        case="north_star/replay_1000", pushes=pushes,
        push_many_ms=round(got["cuda"]["wall"] * 1e3 / pushes, 4),
        plain_push_many_ms_cpu=round(got["cpu"]["wall"] * 1e3 / pushes, 4),
        launches=got["cuda"]["launches"], plans=got["cuda"]["plans"])
    print("branch_kernel", json.dumps(line), flush=True)
    return line


def phase_branch_kernel(small_only: bool):
    """Every entry of ``csrc/branch_step.cu`` against its plain twin on
    the card, bitwise: pushes at the single north star's restore shape
    (R=256, W=514, a branch of 5,000 columns, every read active and none;
    each also forced onto the slab plan), the
    dual restore's largest batch (92 slots in place, R=64, W=258, late
    and inactive rows, early termination), an expansion (the source
    pushed in place, its siblings cloned from it) and a cycle of rows
    each writing the slot the next reads (gather before scatter), a batch
    with a row that overflows the band at E=8 (nothing may commit),
    ``plan_gate``'s alphabet (A=256, R=256, 12 clones pushed, the
    wildcard), W=2050 and W=139266 (the slab plan), copies without stats,
    and root, stats, finalize and deactivate; then 1,000 in-place restore
    pushes with no read active through ``TorchScorer.push_many``.  Returns
    the kernel table's numbers (the north star's restore push) and the
    max error."""
    import numpy as np

    L = 600 if small_only else 6000
    clen = L - 500
    ns = _branch_store(11, 4, 256, L, 256, (clen, clen, 0, 0),
                       inactive=((1, None),), late=((7, 300), (99, 200)))
    forced = ("slab",)
    cases = [
        ("north_star/restore_all_active", ns, "advance", [(0, 0, 2)],
         dict(variants=forced)),
        ("north_star/restore_none_active", ns, "advance", [(1, 1, 3)],
         dict(variants=forced)),
        ("north_star/expand", ns, "advance",
         [(0, 2, 1), (0, 3, -1), (0, 0, 0)], dict(variants=("slab",))),
        ("north_star/copy", ns, "copy", [(0, 2, -1), (1, 3, -1)],
         dict(variants=forced)),
        ("north_star/root", ns, "root", None, {}),
        ("north_star/stats", ns, "stats", [0, 1, 3], dict(variants=("slab",))),
        ("north_star/finalize", ns, "finalize", [0, 1], {}),
        ("north_star/deactivate", ns, "deactivate",
         [[0, 0, 1, 0], [3, 100, 5, 3]], {}),
        ("overflow/E8", _branch_store(13, 4, 16, 400, 8, (300, 300, 0, 0),
                                      garbage=(1,)), "advance",
         [(0, 2, 1), (1, 1, 2), (0, 0, 3)],
         dict(overflow=True, variants=forced)),
    ]
    if not small_only:
        nd = 128
        dual = _branch_store(
            12, nd, 64, 3000, 128, [2500 - 7 * b for b in range(nd)],
            late=((5, 300), (17, 900)), inactive=((3, 9), (40, 2)))
        wide_a = _branch_store(14, 32, 256, 320, 128, (200,) * 16 + (0,) * 16,
                               A=256)
        cases += [
            ("dual/restore_92", dual, "advance",
             [(b, b, b % 4) for b in range(92)],
             dict(A=4, wc=-2, et=True, variants=("slab",))),
            ("dual/cycle", dual, "advance",
             [(0, 1, 1), (1, 2, 2), (2, 0, -1), (5, 100, 3), (5, 101, -1)],
             dict(variants=forced)),
            ("plan_gate/A256", wide_a, "advance",
             [(k, 16 + k, (37 * k) % 256 if k % 3 else -1)
              for k in range(12)], dict(A=256, wc=255, variants=("slab",))),
            ("plan_gate/A256_stats", wide_a, "stats", list(range(12)),
             dict(A=256)),
            ("wide/W2050", _branch_store(15, 4, 16, 3000, 1024,
                                         (2500, 2400, 0, 0)), "advance",
             [(0, 0, 1), (1, 2, 0), (1, 3, -1)], {}),
            ("wide/W139266", _branch_store(16, 2, 16, 1000, 69632, (300, 0)),
             "advance", [(0, 0, 2), (0, 1, -1)], {}),
        ]
    worst, first = 0, None
    for label, store, entry, rows, opt in cases:
        if entry == "root":
            import torch

            act = torch.ones(store[0]["act"].shape[1], dtype=torch.bool,
                             device="cuda")
            act[::7] = False
            rows = (2, act)
        timing, err = branch_case(label, store, entry, rows, **opt)
        worst = max(worst, err)
        first = first or timing
    branch_replay_case(pushes=200 if small_only else 1000)
    return first, worst


def sharded_col_step_bound(R, W, A, shards=1):
    """(bound_ms, bound_by) of one card's share of ``sharded_col_step``
    (``waffle_con_tpu/parallel/mesh.py:284``; the port's
    ``waffle_con_tpu_torch/parallel/mesh.py``): one column step of ``R /
    shards`` reads of ``W`` cells, the band read and written, the read
    window (int16) gathered, nine per-read fields read or written, ``occ
    [R, A]`` and ``split`` written, 20 int32 operations a cell; the sum
    of the three partials across shards is left out.  With ``shards``
    co-resident on one card, the card's share is the whole step
    (``shards=1``)."""
    r = R // shards
    nbytes = 2 * 4 * r * W + 2 * r * W + 4 * 9 * r + 4 * r * (A + 1)
    return bound(nbytes, OPS_PER_CELL * r * W)


# ---------------------------------------------------------------------
# phases 22-23: read-axis sharding (the sharded column step, and the
# engines on a read-sharded store)

#: shards of ``mesh_main``'s sharded stores
MESH_SHARDS = 4


def mesh_devices(n):
    """``n`` shard devices: round-robin over the cards, so on a one-card
    machine all ``n`` share ``cuda:0`` (co-resident shards)."""
    import torch

    cards = torch.cuda.device_count()
    return tuple(f"cuda:{i % cards}" for i in range(n))


def _mesh_inputs(store, slot, devs):
    """The sharded column step's inputs: slot ``slot`` of a branch store
    on the card, its per-read fields split over ``devs``."""
    from waffle_con_tpu_torch.ops.state_io import split_reads

    st, rd, rl = store
    per = {k: split_reads(st[k][slot], devs)
           for k in ("D", "e", "rmin", "er", "off", "act")}
    return ([per[k] for k in ("D", "e", "rmin", "er", "off", "act")]
            + [st["cons"][slot], int(st["clen"][slot]),
               split_reads(rd, devs), split_reads(rl, devs)])


def _mesh_out(out):
    """A sharded step's outputs gathered: six numpy arrays and three
    scalars."""
    from waffle_con_tpu_torch.ops.state_io import gather_reads

    return ([gather_reads(parts) for parts in out[:6]]
            + [int(out[6]), bool(out[7]), bool(out[8])])


def _mesh_err(a, b):
    """Max abs difference of two gathered outputs (raises on a shape or
    dtype mismatch)."""
    import numpy as np

    err = 0
    for x, y in zip(a[:6], b[:6]):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"mesh: {x.shape} {x.dtype} vs {y.shape} "
                                 f"{y.dtype}")
        err = max(err, int(np.abs(x.astype(np.int64)
                                  - y.astype(np.int64)).max(initial=0)))
    return max(err, *(abs(int(p) - int(q)) for p, q in zip(a[6:], b[6:])))


def phase_mesh_kernel(small_only: bool):
    """The sharded column step (``parallel/mesh.py``'s
    ``sharded_col_step``: the shards on one card as one fused call of
    ``csrc/branch_step.cu``, the partials summed in the kernel) at 1, 2
    and 4 shards against its plain version (every shard's
    ``advance_plain`` under the all-or-nothing rule, the same sum), the
    one-call-a-shard route (forced, ``route="per_shard"``) and the
    unsharded branch step (the 1-shard kernel), bitwise: the single north
    star's column (R=256, W=514, A=4, 5,000 columns in) and an overflow at
    E=8 (R=16, every shard forced to commit).  One line a case and shard
    count: the route and its launches a call (one a card), events ms and
    device ms of both routes, the kernels' device ms, the bound.  Returns
    ``(timing, max_err)`` of the north-star column on 4 shards for the
    kernel table."""
    from waffle_con_tpu_torch.ops import sharded_scorer as ss
    from waffle_con_tpu_torch.parallel import make_mesh, sharded_col_step

    cases = [("north_star", _branch_store(17, 1, 256, 10000, 256, (5000,)),
              (256, 514, 4))]
    if not small_only:
        cases.append(("overflow/E8", _branch_store(
            13, 1, 16, 400, 8, (300,), garbage=(0,)), (16, 18, 4)))
    smi = smi_line()
    worst, first = 0, None
    reps = 5 if small_only else 20
    for label, store, (R, W, A) in cases:
        sym = int(store[0]["cons"][0, int(store[0]["clen"][0])])
        ref = None
        for k in (1, 2, MESH_SHARDS):
            devs = mesh_devices(k)
            mesh = make_mesh(devices=devs)
            step = sharded_col_step(mesh, num_symbols=A)
            per_shard = sharded_col_step(mesh, num_symbols=A,
                                         route="per_shard")
            plain = sharded_col_step(mesh, num_symbols=A, plain=True)
            groups = ss.shard_groups(mesh.devices)
            args = _mesh_inputs(store, 0, mesh.devices) + [sym, -2, False]
            before = ss.shard_step.launches
            got = _mesh_out(step(*args))
            launches = ss.shard_step.launches - before
            before = ss.shard_step.launches
            got_per = _mesh_out(per_shard(*args))
            launches_per = ss.shard_step.launches - before
            want = _mesh_out(plain(*args))
            err = _mesh_err(got, want)
            err_per = _mesh_err(got, got_per)
            ref = got if ref is None else ref
            err_unsharded = _mesh_err(got, ref)
            if err or err_per or err_unsharded:
                raise AssertionError(
                    f"mesh_kernel {label} shards={k}: kernel vs plain "
                    f"{err}, vs a call a shard {err_per}, vs the unsharded "
                    f"branch step {err_unsharded}")
            if launches != len(groups) or launches_per != k:
                raise AssertionError(
                    f"mesh_kernel {label}: {launches} fused launches for "
                    f"{len(groups)} card(s), {launches_per} a shard for "
                    f"{k} shards")
            ms = _time_cuda(lambda: step(*args), reps)
            per_ms = _time_cuda(lambda: per_shard(*args), reps)
            plain_ms = _time_cuda(lambda: plain(*args), max(2, reps // 4))
            # device time a step: every activity (the inputs' copies into
            # the one-slot stores, the partials' zeroing and adds) and the
            # branch-step kernels alone
            dev_ms, by_name = _device_ms(
                lambda: [step(*args) for _ in range(reps)])
            kern_ms = sum(_kernel_ms(by_name, kn) for kn in BRANCH_KERNELS)
            per_dev_ms, _ = _device_ms(
                lambda: [per_shard(*args) for _ in range(reps)])
            b_one, by_one = sharded_col_step_bound(R, W, A, 1)
            b_share, _ = sharded_col_step_bound(R, W, A, k)
            per_dev = {}
            for d in mesh.devices:
                per_dev[str(d)] = per_dev.get(str(d), 0) + 1
            line = dict(
                case=label, shards=k, shards_per_device=per_dev, R=R, W=W,
                A=A, overflow=got[8], total=got[6], reached_any=got[7],
                route="fused" if len(groups) == 1 else "a call a card",
                groups=[[str(d), ks] for d, ks in groups],
                launches=launches, launches_per_shard_route=launches_per,
                max_abs_err=err, max_abs_err_vs_per_shard=err_per,
                max_abs_err_vs_unsharded=err_unsharded, ms=round(ms, 4),
                device_ms=None if dev_ms is None else round(dev_ms / reps, 5),
                kernels_device_ms=round(kern_ms / reps, 5),
                per_shard_ms=round(per_ms, 4),
                per_shard_device_ms=None if per_dev_ms is None
                else round(per_dev_ms / reps, 5),
                plain_ms=round(plain_ms, 4), bound_ms=b_one,
                bound_by=by_one, bound_ms_card_share_distinct=b_share,
                smi=smi)
            print("mesh_kernel", json.dumps(line), flush=True)
            if label == "north_star" and k == MESH_SHARDS:
                # where the host time of a fused step goes
                print("mesh_profile", json.dumps(host_profile(
                    lambda: [step(*args) for _ in range(20)], top=12)),
                      flush=True)
            worst = max(worst, err, err_per)
            if label == "north_star" and k == MESH_SHARDS:
                first = dict(ms=round(ms, 4), plain_ms=round(plain_ms, 4),
                             bound_ms=b_one, bound_by=by_one,
                             device_ms=line["device_ms"],
                             kernels_device_ms=round(kern_ms / reps, 5),
                             per_shard_ms=round(per_ms, 4))
    # the shard instances of the run, dual-run and arena kernels
    phase_mesh_run_kernels(small_only, smi, 3 if small_only else 5)
    return first, worst


# the shard instances of the run, dual-run and arena kernels: one launch
# for every shard of a read-sharded store on one card

#: kernel -> its 4-shard numbers in ``mesh_kernel`` (for the kernel table)
MESH_RUN_CHECKS = {}


def _mesh_split(st, rd, rl, k):
    """A one-store state, its reads and lengths split over ``k``
    co-resident shards of ``cuda:0``: ``(states, reads, rlens)``."""
    from waffle_con_tpu_torch.ops.state_io import (
        split_reads, split_state, state_to_numpy)

    devs = ("cuda:0",) * k
    return (split_state(state_to_numpy(st), devs), split_reads(rd, devs),
            split_reads(rl, devs))


def _np_store(st):
    """A copy of a store (one dict, or the shards' dicts gathered in read
    order) as numpy arrays."""
    import numpy as np
    from waffle_con_tpu_torch.ops.state_io import gather_state, state_to_numpy

    got = gather_state(st) if isinstance(st, list) else state_to_numpy(st)
    return {k: np.array(v) for k, v in got.items()}


def _np_err(a, b):
    """Max abs difference of two lists of numpy arrays (raises on a shape
    that differs)."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {x.shape} vs {y.shape}")
        if x.size:
            err = max(err, int(abs(x.astype("int64")
                                   - y.astype("int64")).max()))
    return err


def _slot_rows_err(a, b, slots):
    """Max abs difference of the rows of ``slots`` in two numpy stores:
    band, folds, offsets, activity, length and the consensus up to it."""
    err = 0
    for slot in slots:
        err = max(err, _np_err([a[k][slot] for k in ("D", "e", "rmin", "er",
                                                     "off", "act", "clen")],
                               [b[k][slot] for k in ("D", "e", "rmin", "er",
                                                     "off", "act", "clen")]))
        n = int(a["clen"][slot])
        err = max(err, _np_err([a["cons"][slot, :n]], [b["cons"][slot, :n]]))
    return err


class MeshRunCase(NamedTuple):
    """One call of a kernel held as a shard instance: ``kind`` (``run``,
    ``dual`` or ``arena``), the unsharded store, reads and lengths, the
    call's other inputs after the reads (``pre`` are the run's and the
    dual's slots, which come before them), and the kernel's
    ``RunArgs`` / ``DualRunArgs`` / ``ArenaArgs``."""

    label: str
    kind: str
    state: dict
    reads: object
    rlen: object
    pre: tuple
    post: tuple
    args: object


def _mesh_fns(kind):
    """``(shard instance, its plain version, the unsharded kernel, the
    kernel's device name, its fetch)`` of a kind."""
    from waffle_con_tpu_torch.ops import arena_kernel as ak
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
    from waffle_con_tpu_torch.ops import run_kernel as rk

    return {
        "run": (rk.run_extend_shards_cuda, rk.run_extend_shards_plain,
                rk.run_extend_cuda, "run_extend_kernel"),
        "dual": (rdk.run_extend_dual_shards_cuda,
                 rdk.run_extend_dual_shards_plain, rdk.run_extend_dual_cuda,
                 "run_extend_dual_kernel"),
        "arena": (ak.arena_shards_cuda, ak.arena_shards_plain, ak.arena_cuda,
                  "arena_kernel"),
    }[kind]


def _mesh_call(case, fn, st, rd, rl):
    """``fn`` on a store (or the shards' stores) in the argument order of
    its kind: the run's and the dual's slots before the reads, the
    arena's inputs after them."""
    if case.kind == "arena":
        return fn(st, rd, rl, *case.post, case.args)
    return fn(st, *case.pre, rd, rl, *case.post, case.args)


def _mesh_result(case, outs, R, A):
    """A call's outputs as numpy arrays (the run's packed fields as
    ``unpack`` gives them, the records up to their count) and what its
    line reports: ``(arrays, steps, code, result)``."""
    import numpy as np
    from waffle_con_tpu_torch.ops import arena_kernel as ak
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
    from waffle_con_tpu_torch.ops import run_kernel as rk

    none = np.zeros(0, np.int64)
    if case.kind == "run":
        res, rs, rf = rk.fetch(*outs, R, A, case.args.max_steps)
        arrays = [np.array([res.steps, res.code, res.rec_count,
                            int(res.fin_ovf), res.clen])]
        arrays += [np.asarray(getattr(res, f)) for f in
                   ("eds", "split", "reached", "fin", "occ", "syms")]
        arrays += [none if rs is None else rs, none if rf is None else rf]
        return arrays, res.steps, res.code, res
    if case.kind == "dual":
        res, rs, rp = rdk.fetch(*outs, R, A, case.args.max_steps)
        arrays = [outs[0].cpu().numpy(), none if rs is None else rs,
                  none if rp is None else rp]
        return arrays, res.steps, res.code, res
    K = len(case.post[1])
    res = ak.unpack(outs.cpu().numpy(), K, R, A, case.args.max_steps)
    return [outs.cpu().numpy()], res.nsteps, res.code, res


def _mesh_touched(case, res):
    """The slots a call changed, whose rows the plain version must match."""
    if case.kind == "arena":
        return _arena_real_rows(res, case.post[0], case.args)
    return list(case.pre)


def _mesh_bound(case, steps, R, W, out_words):
    """The unsharded kernel's bound for the same work (the kernel table's
    rows: ``phase_kernel``'s, ``dual_bound``, ``arena_bound``)."""
    import numpy as np
    from waffle_con_tpu_torch.ops import arena_kernel as ak

    if case.kind == "run":
        nbytes = 2 * R * W * 4 + R * (steps + W) * 2
        return bound(nbytes, steps * R * W * OPS_PER_CELL)
    if case.kind == "dual":
        act = [int(case.state["act"][sl].sum()) for sl in case.pre]
        unlocked = [not case.args.lock1, not case.args.lock2]
        return dual_bound(R, W, steps,
                          sum(a for a, u in zip(act, unlocked) if u))
    (_slots, kinds, lc, _pc, _tr, mc_tab, imb_tab) = case.post
    lay_in = ak.arena_in_layout(len(kinds), np.asarray(lc).shape[1],
                                len(mc_tab), len(imb_tab))
    return arena_bound(ak.arena_plain.stepped_rows, W, lay_in["imb_tab"][1],
                       out_words)


def mesh_run_case(case, reps, smi):
    """One call through the shard instance at 1, 2 and 4 co-resident
    shards of ``cuda:0``, each launch held bitwise against the plain
    version on the same shards and against the unsharded kernel on the
    unsharded store (every output, and the whole store gathered in read
    order; the plain version's rows of the slots the call changed).  One
    line a shard count: launches, events ms and device ms of the sharded
    and of the unsharded launch, the plain version's ms, the bound of the
    unsharded kernel's row.  Returns ``(numbers at 4 shards, max err, the
    stop code)``."""
    import torch

    fused, plain, unsharded, kname = _mesh_fns(case.kind)
    R, W = case.state["D"].shape[1:]
    A = case.args.a_real
    st_u = _copy_state(case.state)
    outs_u = _mesh_call(case, unsharded, st_u, case.reads, case.rlen)
    want, steps, code, res = _mesh_result(case, outs_u, R, A)
    want_store = _np_store(st_u)
    it = iter([_copy_state(case.state) for _ in range(reps)])
    u_ms = _time_cuda(lambda: _mesh_call(case, unsharded, next(it),
                                         case.reads, case.rlen), reps)
    it = iter([_copy_state(case.state) for _ in range(reps)])
    u_dev, u_by = _device_ms(lambda: [_mesh_call(
        case, unsharded, next(it), case.reads, case.rlen)
        for _ in range(reps)])
    worst, numbers = 0, None
    for k in (1, 2, MESH_SHARDS):
        states, rds, rls = _mesh_split(case.state, case.reads, case.rlen, k)
        st_k = [_copy_state(s) for s in states]
        st_p = [_copy_state(s) for s in states]
        before = fused.launches
        outs_k = _mesh_call(case, fused, st_k, rds, rls)
        launches = fused.launches - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs_p = _mesh_call(case, plain, st_p, rds, rls)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        got, _s, _c, _r = _mesh_result(case, outs_k, R, A)
        ref, _s, _c, _r = _mesh_result(case, outs_p, R, A)
        got_store, ref_store = _np_store(st_k), _np_store(st_p)
        err_plain = max(_np_err(got, ref), _slot_rows_err(
            got_store, ref_store, _mesh_touched(case, res)))
        err_unsharded = max(_np_err(got, want), _np_err(
            list(got_store.values()), list(want_store.values())))
        if err_plain or err_unsharded or launches != 1:
            raise AssertionError(
                f"mesh_kernel {case.label} shards={k}: {launches} launches, "
                f"vs plain {err_plain}, vs the unsharded kernel "
                f"{err_unsharded}")
        bms, by = _mesh_bound(case, steps, R, W, want[0].size)
        copies = [[_copy_state(s) for s in states] for _ in range(2 * reps)]
        it = iter(copies)
        ms = _time_cuda(lambda: _mesh_call(case, fused, next(it), rds, rls),
                        reps)
        dev, by_name = _device_ms(lambda: [
            _mesh_call(case, fused, next(it), rds, rls) for _ in range(reps)])
        line = dict(
            case=case.label, kernel=kname, shards=k, rows_per_shard=R // k,
            R=R, W=W, A=A, steps=steps, code=code, launches=launches,
            max_abs_err=err_plain, max_abs_err_vs_unsharded=err_unsharded,
            ms=round(ms, 4),
            # None where the profiler saw no device activity
            device_ms=None if dev is None else round(dev / reps, 5),
            kernel_device_ms=None if dev is None
            else round(_kernel_ms(by_name, kname) / reps, 5),
            unsharded_ms=round(u_ms, 4),
            unsharded_device_ms=None if u_dev is None
            else round(u_dev / reps, 5),
            unsharded_kernel_device_ms=None if u_dev is None
            else round(_kernel_ms(u_by, kname) / reps, 5),
            plain_ms=round(p_ms, 3), bound_ms=bms, bound_by=by, smi=smi)
        print("mesh_kernel", json.dumps(line), flush=True)
        worst = max(worst, err_plain, err_unsharded)
        if k == MESH_SHARDS:
            numbers = dict(
                shard_instance_case=case.label, shard_instance_ms=line["ms"],
                shard_instance_device_ms=line["device_ms"],
                shard_instance_kernel_device_ms=line["kernel_device_ms"],
                shard_instance_unsharded_ms=line["unsharded_ms"],
                shard_instance_plain_ms=line["plain_ms"],
                shard_instance_bound_ms=bms)
        del st_k, st_p, copies
    return numbers, worst, code


def _first_arena_call(reads, **cfg):
    """The first arena call of a dual search of ``reads`` on the card."""
    from waffle_con_tpu_torch import CdwfaConfigBuilder, DualConsensusDWFA

    b = CdwfaConfigBuilder().backend("torch").device("cuda")
    for k, v in cfg.items():
        b = getattr(b, k)(v)
    eng = DualConsensusDWFA(b.build())
    for r in reads:
        eng.add_sequence(r)
    with ArenaRecorder(1) as rec:
        eng.consensus()
    return rec.calls[0]


def mesh_run_cases(small_only: bool):
    """The shard instances' cases: the single north star's root run
    (R=256, W=514, A=4, capped at 100 steps: ``north_star/step_cap``),
    a dual north-star run (split sides from just past the second SNP, 300
    steps), the dual north star's first arena call, and a run whose band
    of E=8 overflows (R=16); with ``small_only`` a small draw of each
    kind instead of the north stars."""
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    cases = []
    small = lambda seed: lambda: generate_test(4, 120, 10, 0.0, seed=seed)  # noqa: E731
    run_draws = [("run/overflow_E8", _one_random_read(small(5)), {},
                  dict(max_steps=120), 5)]
    if not small_only:
        ns = lambda: generate_test(4, 10000, 256, 0.01, seed=0)  # noqa: E731
        run_draws.insert(0, ("run/north_star_step_cap", ns,
                             dict(initial_band=216, min_count=64),
                             dict(max_steps=100, min_count=64), 4))
    for label, make, cfg, kw, want_code in run_draws:
        truth, reads = make()
        sc = _scorer(reads, **cfg)
        h = _case_state(sc)
        args = _run_args(sc, 0, first_sym=sc.sym_id[truth[0]], **kw)
        cases.append((MeshRunCase(label, "run", _copy_state(sc._state),
                                  sc._reads, sc._rlen, (sc._slot_of[h],), (),
                                  args), want_code))
    if small_only:
        t1, t2, reads = _small_dual(51, 0.0)
        cfg, spec = dict(min_count=3), dict(min_count=3)
        kw = dict(min_count=3, max_steps=60)
    else:
        t1, t2, reads = dual_north_star()
        cfg = dict(min_count=16, initial_band=116)
        spec, kw = dict(min_count=16, advance=2570), dict(min_count=16,
                                                          max_steps=300)
    sc = _scorer(reads, **cfg)
    ha, hb, c1, c2 = _dual_state(sc, t1, t2, spec)
    args, mc, imb = _dual_args(sc, c1, c2, kw)
    cases.append((MeshRunCase(
        "dual/north_star_run" if not small_only else "dual/small", "dual",
        _copy_state(sc._state), sc._reads, sc._rlen,
        (sc._slot_of[ha], sc._slot_of[hb]), (mc, imb), args), None))
    if small_only:
        rec = _first_arena_call([r for r, _o in _dual_workload()],
                                min_count=3)
        label = "arena/dual_split_first_call"
    else:
        # dual_main's recording when that phase ran
        rec = (ARENA_RECORDS.get("dual_main") or [None])[0] or (
            _first_arena_call(reads, min_count=16, initial_band=116))
        label = "arena/dual_north_star_first_call"
    (rd, rl, *post, args) = rec["inputs"]
    cases.append((MeshRunCase(label, "arena", _copy_state(rec["state"]), rd,
                              rl, (), tuple(post), args), None))
    return cases


def phase_mesh_run_kernels(small_only: bool, smi, reps):
    """Every shard-instance case (:func:`mesh_run_cases`); keeps each
    kernel's 4-shard numbers of its first case in
    :data:`MESH_RUN_CHECKS`.  Returns the max error."""
    worst = 0
    names = dict(run="run_extend", dual="run_extend_dual", arena="arena")
    for case, want_code in mesh_run_cases(small_only):
        numbers, err, code = mesh_run_case(case, reps, smi)
        worst = max(worst, err)
        if want_code is not None and code != want_code:
            raise AssertionError(f"mesh_kernel {case.label}: code {code}, "
                                 f"want {want_code}")
        name = names[case.kind]
        if name not in MESH_RUN_CHECKS:
            MESH_RUN_CHECKS[name] = (numbers, err)
    return worst


def _mesh_search(kind, spec, cfg):
    """One search of a deployment on ``cfg``: ``(result as plain data,
    wall, launches by kernel, shard-step launches, the last
    ``scorer_sharded`` event, the engine)``."""
    import torch
    from waffle_con_tpu_torch.ops import sharded_scorer as ss
    from waffle_con_tpu_torch.runtime import events

    eng = _engine_for(kind, spec, cfg)
    reset_launch_counts()
    ss.shard_step.launches = 0
    ss.partials_plain.calls = 0
    shards0 = _shard_instance_launches()
    events.clear_events()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.consensus()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    counts["plain"] += ss.partials_plain.calls
    counts["branch_entries"] = branch_launches()[1]
    counts["fused_shards"] = _fused_shards()
    counts["fused_launches"] = _fused_launches()
    counts["shard_instances"] = _shard_instance_launches() - shards0
    placed = events.get_events("scorer_sharded")
    return (_result_key(kind, res), wall, counts, ss.shard_step.launches,
            placed[-1] if placed else None, eng)


def _per_shard_search(kind, spec, cfg):
    """One warm search of a deployment on the sharded store's
    one-call-a-shard route (``route="per_shard"``, forced for the
    comparison): ``(result, wall, launches, host rollbacks)``."""
    from waffle_con_tpu_torch.ops.sharded_scorer import ShardedScorer
    from waffle_con_tpu_torch.parallel import mesh as tmesh

    def per_shard(reads, config, devices):
        return ShardedScorer(reads, config, devices, route="per_shard")

    tmesh.ShardedScorer = per_shard
    try:
        got, wall, counts, _n, _ev, eng = _mesh_search(kind, spec, cfg)
    finally:
        tmesh.ShardedScorer = ShardedScorer
    c = eng.last_search_stats.get("scorer_counters", {})
    return got, wall, counts, c.get("shard_overflow_rollbacks", 0)


#: the kernels a sharded store runs as shard instances (launch-count keys)
RUN_KERNELS = ("run_extend", "run_extend_dual", "arena")


def _shard_instance_launches():
    """Launches of the run, dual-run and arena kernels' shard instances."""
    from waffle_con_tpu_torch.ops import arena_kernel as ak
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
    from waffle_con_tpu_torch.ops import run_kernel as rk

    return (rk.run_extend_shards_cuda.launches
            + rdk.run_extend_dual_shards_cuda.launches
            + ak.arena_shards_cuda.launches)


def _fused_shards():
    from waffle_con_tpu_torch.ops import branch_kernel as bk

    return {str(k): v for k, v in bk.branch_cuda.fused_shards.items()}


def _fused_launches():
    from waffle_con_tpu_torch.ops import branch_kernel as bk

    return bk.branch_cuda.fused_launches


#: the branch store's calls that make one branch-step call each
STORE_CALLS = ("root", "copy", "advance", "stats", "finalize")


def one_launch_a_call(name, counts, shards):
    """Fails unless every branch-step call of a sharded search on
    co-resident shards was one fused call over all ``shards``: fused
    calls = the store's calls, every launch other than a deactivation a
    fused call's, one launch a call on ``one_launch`` and two (rows, then
    the commit) on ``slab``.  Returns ``(fused calls, their launches, the
    calls on slab)``."""
    ent = counts["branch_entries"]
    fused, kernels = ent["fused"], counts["fused_launches"]
    calls = sum(ent[k] for k in STORE_CALLS)
    # a root has no plan: one launch
    launches = counts["branch_step"] - ent["deactivate"]
    if (not fused or fused != calls or launches != kernels
            or counts["fused_shards"] != {str(shards): fused}
            or ent["one_launch"] + ent["slab"] + ent["root"] != fused
            or kernels > ent["one_launch"] + ent["root"] + 2 * ent["slab"]):
        raise AssertionError(
            f"mesh_main {name}: {fused} fused calls ({kernels} launches), "
            f"{calls} store calls, {launches} launches, by shards "
            f"{counts['fused_shards']}, plans {ent}")
    return fused, kernels, ent["slab"]


def phase_mesh_main():
    """The engines on a read-sharded store (``mesh_shards=4``, the shards
    co-resident on a one-card machine through a pinned ``DeviceSet``):
    the single north star (256 x 10 kb at 1 %, cold and warm), the
    priority north star and the dual north star (64 reads x 5 kb).  Each
    result must equal the unsharded ``"torch"`` search's and the C++
    engine's byte for byte.  On co-resident shards the run, dual-run and
    arena kernels launch their shard instances (one launch a call for the
    four shards) exactly as often as the unsharded search launches the
    kernels, the gang kernel never (the store offers no gang), no plain
    version runs and no planner refuses; every branch-step call of the
    store is one fused launch over the four shards, with no host
    rollback.  Returns the shard-step launches of the three searches
    (warm where run twice) and the run kernels' launches by kernel."""
    import dataclasses

    from waffle_con_tpu_torch import CdwfaConfigBuilder
    from waffle_con_tpu_torch.parallel import DeviceSet, use_device_set
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    smi = smi_line()
    devs = mesh_devices(MESH_SHARDS)
    pinned = DeviceSet("mesh", devs)
    single = BASELINE.get("single")
    if single is None:
        truth, reads = generate_test(4, 10000, 256, 0.01, seed=0)
        cfg = (CdwfaConfigBuilder().backend("torch").device("cuda")
               .min_count(64).initial_band(216).build())
        single = dict(reads=reads, offsets=None, config=cfg)
    prio = BASELINE.get("priority")
    if prio is None:
        _t, _h, chains = priority_north_star()
        b = CdwfaConfigBuilder().backend("torch").device("cuda")
        for k, v in PRIORITY_CFG.items():
            b = getattr(b, k)(v)
        prio = dict(chains=chains, config=b.build())
    dual = BASELINE.get("dual")
    if dual is None:
        _t1, _t2, dual_reads = dual_north_star()
        dual = dict(reads=dual_reads, offsets=None, config=(
            CdwfaConfigBuilder().backend("torch").device("cuda")
            .min_count(16).initial_band(116).build()))
    draws = [("single", "single", single, ("cold", "warm")),
             ("priority", "priority", prio, ("cold",)),
             ("dual", "dual", dual, ("cold",))]
    total = 0
    runs_total = dict.fromkeys(RUN_KERNELS, 0)
    for name, kind, spec, runs in draws:
        cfg = spec["config"]
        want, wall_plain, counts_plain, _n, _ev, _e = _mesh_search(
            kind, spec, cfg)
        if spec.get("want") is not None and want != spec["want"]:
            raise AssertionError(f"mesh_main {name}: the unsharded search "
                                 "differs from its main phase's")
        cpp, cpp_s = _cpp_run(kind, spec)
        if cpp != want:
            raise AssertionError(f"mesh_main {name}: C++ differs from the "
                                 "unsharded torch search")
        sharded_cfg = dataclasses.replace(cfg, mesh_shards=MESH_SHARDS)
        walls = []
        with use_device_set(pinned):
            for run in runs:
                got, wall, counts, shard_launches, placed, eng = _mesh_search(
                    kind, spec, sharded_cfg)
                walls.append(wall)
                if got != want:
                    raise AssertionError(f"mesh_main {name} {run}: the "
                                         "sharded result differs")
                c = eng.last_search_stats.get("scorer_counters", {})
                plan_refusals(f"mesh_main {name} {run}", c)
                runs = {k: counts[k] for k in RUN_KERNELS}
                want_runs = {k: counts_plain[k] for k in RUN_KERNELS}
                if (runs != want_runs or counts["run_ragged"]
                        or counts["branch_step"] <= 0 or counts["plain"]
                        or shard_launches <= 0):
                    raise AssertionError(
                        f"mesh_main {name} {run}: launches {counts} against "
                        f"the unsharded search's {counts_plain}, shard "
                        f"steps {shard_launches}")
                if len(set(devs)) == 1 and counts["shard_instances"] != sum(
                        runs.values()):
                    raise AssertionError(
                        f"mesh_main {name} {run}: {counts['shard_instances']}"
                        f" shard-instance launches of {runs}")
                if len(set(devs)) == 1:
                    # co-resident: one fused call a store call, no rollback
                    fused = one_launch_a_call(name, counts, MESH_SHARDS)
                    if c.get("shard_overflow_rollbacks", 0):
                        raise AssertionError(
                            f"mesh_main {name}: a host rollback on "
                            "co-resident shards")
        c = eng.last_search_stats.get("scorer_counters", {})
        prof = per_shard = None
        if name == "single":
            # where a sharded column's host time goes (one more search),
            # and the same search on the one-call-a-shard route
            with use_device_set(pinned):
                prof = host_profile(lambda: _mesh_search(
                    kind, spec, sharded_cfg), top=15)
                per_shard = _per_shard_search(kind, spec, sharded_cfg)
            if per_shard[0] != want:
                raise AssertionError(f"mesh_main {name}: the per-shard "
                                     "route's result differs")
        total += shard_launches
        for k in RUN_KERNELS:
            runs_total[k] += counts[k]
        print("mesh_main", json.dumps(dict(
            deployment=name, shards=MESH_SHARDS,
            placement=None if placed is None else dict(
                devices=placed["devices"], rows=placed["reads"],
                rows_per_shard=placed["reads"] // MESH_SHARDS),
            sharded_s=[round(w, 3) for w in walls],
            unsharded_s=round(wall_plain, 3), cpp_s=round(cpp_s, 3),
            sharded_over_unsharded=round(min(walls) / wall_plain, 2),
            identical_to_unsharded_and_cpp=True,
            launches_sharded=counts, shard_step_launches=shard_launches,
            launches_unsharded=counts_plain,
            pops=eng.last_search_stats.get("nodes_explored", 0)
            + eng.last_search_stats.get("nodes_ignored", 0),
            push_calls=c.get("push_calls"),
            clone_push_calls=c.get("clone_push_calls"),
            rollbacks=c.get("shard_overflow_rollbacks", 0),
            grow_e_events=c.get("grow_e_events", 0),
            fused_calls=None if len(set(devs)) > 1 else fused[0],
            fused_launches=None if len(set(devs)) > 1 else fused[1],
            fused_calls_on_slab=None if len(set(devs)) > 1 else fused[2],
            per_shard_route=None if per_shard is None else dict(
                wall_s=round(per_shard[1], 3),
                branch_launches=per_shard[2]["branch_step"],
                rollbacks=per_shard[3]),
            profile=prof, smi=smi,
        )), flush=True)
    return total, runs_total


# ---------------------------------------------------------------------
# the serving pool: the gang kernel across stores, and the service


def _serve_store(make, prefix, cfg):
    """A ``TorchScorer`` on the card over ``make()``'s reads with one
    branch pushed to the truth's first ``prefix`` symbols: ``(scorer,
    truth, handle)``."""
    import numpy as np

    truth, reads = make()
    sc = _scorer(reads, **cfg)
    h = sc.root(np.ones(sc.num_reads, dtype=bool))
    for k in range(prefix):
        sc.push(h, truth[: k + 1])
    return sc, truth, h


def _draw(length, n, err, seed, wild=None, cut=0):
    """``generate_test(4, length, n, err, seed=seed)``, every 20th base
    the wildcard ``wild`` when given, every other read cut by ``cut``."""
    def make():
        from waffle_con_tpu_torch.utils.example_gen import generate_test

        truth, reads = generate_test(4, length, n, err, seed=seed)
        if wild is not None:
            reads = [bytes(wild if k % 20 == 19 else b
                           for k, b in enumerate(r)) for r in reads]
        if cut:
            reads = [r[: len(r) - cut * (i % 2)] for i, r in enumerate(reads)]
        return truth, reads
    return make


#: (label, members): a member is (draw, scorer config, prefix, call
#: overrides); overrides name ``max_steps``, ``me_budget``,
#: ``other_cost``, ``other_len``, ``first`` ("truth" / "wrong": a forced
#: first symbol), ``l2`` and ``len0_shift`` (a consensus length the slot
#: does not hold: the member must run nothing, code -1)
def serve_kernel_cases(small_only: bool):
    ns = dict(min_count=64, initial_band=216)
    m1 = (_draw(1000, 32, 0.01, 301), dict(min_count=8, initial_band=56),
          200, dict(max_steps=300))
    m2 = (_draw(5000, 64, 0.01, 302), dict(min_count=16, initial_band=116),
          800, dict(max_steps=300, first="truth"))
    m3 = (_draw(3000, 256, 0.01, 303), ns, 1500, dict(max_steps=300))
    # one north-star member (16 CTAs) and seven R 32 / W 130 members (2
    # CTAs each), 300 steps each: 2 packed clusters, 8 unpacked
    small8 = [(_draw(1000, 32, 0.01, 311 + i),
               dict(min_count=8, initial_band=56), 200, dict(max_steps=300))
              for i in range(7)]
    cases = [("mixed3", [m1, m2, m3]), ("mixed8", [m3] + small8)]
    if small_only:
        return cases
    m4 = (_draw(600, 1024, 0.01, 304), ns, 100, dict(max_steps=100))
    cases.append(("mixed4/global_band", [m1, m2, m3, m4]))
    cases.append(("constants", [
        (_draw(300, 16, 0.03, 305), dict(min_count=3), 40,
         dict(max_steps=200, l2=True)),
        (_draw(400, 24, 0.01, 306, wild=ord("*")),
         dict(min_count=3, initial_band=16, wildcard=ord("*")), 60,
         dict(max_steps=120, first="wrong")),
        (_draw(350, 20, 0.01, 307, cut=2),
         dict(min_count=3, initial_band=32, allow_early_termination=True),
         80, dict(max_steps=400)),
        (_draw(300, 40, 0.01, 308), dict(min_count=5, initial_band=16), 50,
         dict(max_steps=100, me_budget=3)),
        (_draw(300, 24, 0.01, 309), dict(min_count=3, initial_band=16), 30,
         dict(max_steps=50, len0_shift=1)),
    ]))
    cases.append(("gang10/two_launches", [
        (_draw(200 + 20 * i, 16 + 4 * i, 0.01, 310 + i),
         dict(min_count=3, initial_band=8 * (1 + i % 3)), 20 + i,
         dict(max_steps=60 + 10 * i)) for i in range(10)]))
    return cases


def _serve_members(stores, states, specs):
    """The gang's members over ``states`` (one copy of each store)."""
    from waffle_con_tpu_torch.ops import ragged_kernel as rgk

    out = []
    for (sc, _truth, h, call), st in zip(stores, states):
        out.append(rgk.Member(
            st, sc._slot_of[h], sc._reads, sc._rlen, call["len0"],
            call["me_budget"], call["other_cost"], call["other_len"],
            call["max_steps"], call["first_sym"], call["min_count"],
            call["l2"], sc._wc, sc._et, sc.num_symbols))
    return out


def serve_bound(members, steps):
    """(bound_ms, bound_by) of a gang launch of members of different
    shapes: each member's band read and written once and its reads'
    windows read once (bytes), 20 int32 operations a band cell a step."""
    nbytes = ops = 0
    for m, s in zip(members, steps):
        R, W, _A, _C = m.shape()
        nbytes += 2 * R * W * 4 + R * (s + W) * 2
        ops += s * R * W * OPS_PER_CELL
    return bound(nbytes, ops)


def _pack_fields(plan):
    """The packing of a gang plan, for a result line."""
    return dict(clusters=plan.clusters, ctas=plan.ctas,
                ctas_launched=plan.clusters * plan.run.cluster,
                waves=plan.waves, slots=[list(x) for x in plan.slots],
                spans=list(plan.spans))


def phase_serve_kernel(small_only: bool):
    """The gang kernel (``csrc/run_ragged.cu``) with members from
    different stores in one launch, at different R, W, C, L, A and search
    constants, in place as the serving pool runs it: every member's packed
    output and slot rows compared bitwise against the plain version
    (``run_members_plain`` on the card) and against the member's solo
    run-kernel launch from the same state.  The members are packed by
    their own cluster size (``plan_members``); the same group is also run
    on the unpacked plan (a cluster of the largest member's size a member,
    every CTA of it held for the member's run as before the packing),
    forced, held bitwise to the packed launch, and timed through the same
    entry (``run_members_cuda`` with each plan given).  One line a case:
    the plan, its clusters, CTAs and waves, ms a launch (CUDA events
    around the call, and device time), the same for the unpacked plan,
    the members' solo launches
    summed, the plain version's ms and the bound.  Device time: launches
    on fresh copies queued behind a spin kernel, CUDA events around them
    (``_launch_device_ms``).  Returns the kernel table's numbers of the
    first case and the max error."""
    import torch
    from waffle_con_tpu_torch.ops import ragged_kernel as rgk
    from waffle_con_tpu_torch.ops import run_kernel as rk

    max_err = 0
    timing = None
    for label, spec in serve_kernel_cases(small_only):
        stores = []
        for make, cfg, prefix, over in spec:
            sc, truth, h = _serve_store(make, prefix, cfg)
            first = over.get("first")
            fs = -1
            if first == "truth":
                fs = sc.sym_id[truth[prefix]]
            elif first == "wrong":
                fs = (sc.sym_id[truth[prefix]] + 1) % sc.num_symbols
            call = dict(
                len0=prefix + over.get("len0_shift", 0),
                me_budget=over.get("me_budget", 2**31 - 1),
                other_cost=over.get("other_cost", 2**31 - 1),
                other_len=over.get("other_len", 0),
                max_steps=over["max_steps"], first_sym=fs,
                min_count=cfg.get("min_count", 3), l2=over.get("l2", False))
            stores.append((sc, truth, h, call))
        st0 = [sc._state for sc, _t, _h, _c in stores]
        copies = lambda: [_copy_state(s) for s in st0]  # noqa: E731
        st_k, st_p, st_u = copies(), copies(), copies()
        before = rgk.run_ragged_cuda.launches
        outs_k, _ = rgk.run_members(_serve_members(stores, st_k, None),
                                    in_place=True)
        n_launch = rgk.run_ragged_cuda.launches - before
        plan = rgk.run_ragged_cuda.last_plan
        members = _serve_members(stores, st_p, None)
        shapes = [m.shape() for m in members]
        one_launch = len(members) <= rgk.MAX_GANG
        unpacked = (rgk.plan_members(shapes, packed=False) if one_launch
                    else None)
        if one_launch:
            outs_u, _ = rgk.run_members_cuda(
                _serve_members(stores, st_u, None), True, plan=unpacked)
            unpacked = rgk.run_ragged_cuda.last_plan
        t0 = time.perf_counter()
        outs_p, _ = rgk.run_members_plain(members, in_place=True)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        steps, codes, bands, solo_ms = [], [], [], 0.0
        for g, (sc, _t, h, call) in enumerate(stores):
            R, W, A = sc._R, sc._W, sc.num_symbols
            slot = sc._slot_of[h]
            ok = outs_k[g].cpu().numpy()
            op = outs_p[g].cpu().numpy()
            res_k = rk.unpack(ok, R, A, call["max_steps"])
            if one_launch:
                res_u = rk.unpack(outs_u[g].cpu().numpy(), R, A,
                                  call["max_steps"])
                if (res_k.code == -1) != (res_u.code == -1) or (
                        res_k.code != -1 and (
                            _result_err(res_k, res_u)
                            or _rows_err(st_k[g], slot, st_u[g], slot))):
                    raise AssertionError(f"{label} member {g}: packed != "
                                         "unpacked launch")
            if res_k.code == -1:
                if list(ok[:5]) != list(op[:5]):
                    raise AssertionError(f"{label} member {g}: "
                                         f"{ok[:5]} vs {op[:5]}")
                steps.append(0)
                codes.append(-1)
                continue
            err = max(_result_err(res_k, rk.unpack(op, R, A,
                                                   call["max_steps"])),
                      _rows_err(st_k[g], slot, st_p[g], slot))
            args = rk.RunArgs(
                me_budget=call["me_budget"], other_cost=call["other_cost"],
                other_len=call["other_len"], min_count=call["min_count"],
                l2=call["l2"], max_steps=call["max_steps"],
                first_sym=call["first_sym"], allow_records=False,
                wc=sc._wc, et=sc._et, a_real=A)
            st_s = _copy_state(st0[g])
            out_s, _rs, _rf = rk.run_extend_cuda(st_s, slot, sc._reads,
                                                 sc._rlen, args)
            bands.append(rk.run_extend_cuda.last_plan.band)
            res_s = rk.unpack(out_s.cpu().numpy(), R, A, call["max_steps"])
            serr = max(_result_err(res_k, res_s),
                       _rows_err(st_k[g], slot, st_s, slot))
            it = iter([_copy_state(st0[g]) for _ in range(3)])
            solo_ms += _time_cuda(lambda: rk.run_extend_cuda(
                next(it), slot, sc._reads, sc._rlen, args), 3)
            max_err = max(max_err, err, serr)
            if err or serr:
                raise AssertionError(
                    f"{label} member {g}: kernel != plain (max err {err}) "
                    f"or != solo launch ({serr})")
            steps.append(res_k.steps)
            codes.append(res_k.code)
        if label.startswith("mixed4") and "global" not in bands:
            raise AssertionError(f"{label}: no member's band in device "
                                 f"memory ({bands})")
        if label == "mixed8" and (plan.clusters, plan.waves) != (2, 1):
            raise AssertionError(f"mixed8: {plan.clusters} clusters in "
                                 f"{plan.waves} waves, want 2 in 1")
        def launch(states, p):
            ms = _serve_members(stores, states, None)
            if one_launch:
                return rgk.run_members_cuda(ms, True, plan=p)
            return rgk.run_members(ms, in_place=True)

        def timed(p):
            # in place, so every launch takes a fresh copy of the stores
            it = iter([copies() for _ in range(7)])
            return (_time_cuda(lambda: launch(next(it), p), 3),
                    _launch_device_ms(lambda: launch(next(it), p), 3))

        u_ms = u_dev_ms = None
        if one_launch:
            # both plans through one entry (run_members_cuda, the plan
            # given), in the order packed, unpacked, unpacked, packed;
            # each plan's two readings averaged
            runs = [timed(p) for p in (plan, unpacked, unpacked, plan)]
            k_ms, dev_ms, u_ms, u_dev_ms = (
                (runs[a][i] + runs[b][i]) / 2
                for a, b in ((0, 3), (1, 2)) for i in (0, 1))
            dev_ms, u_dev_ms = round(dev_ms, 5), round(u_dev_ms, 5)
        else:
            k_ms, dev_ms = timed(None)
        bound_ms, bound_by = serve_bound(members, steps)
        line = dict(
            card=smi_line(), case=label, members=len(stores),
            launches=n_launch,
            shapes=[list(m.shape()) for m in members], steps=steps,
            codes=codes, cluster=plan.run.cluster,
            ctas_threads=plan.run.threads, band=plan.run.band,
            smem_bytes=plan.run.smem_bytes, **_pack_fields(plan),
            coresident_clusters=rgk.max_clusters(plan),
            member_plans=[_plan_fields(p) for p in plan.plans],
            kernel_ms=round(k_ms, 4), device_ms=dev_ms,
            unpacked=None if unpacked is None else dict(
                _pack_fields(unpacked), kernel_ms=round(u_ms, 4),
                device_ms=u_dev_ms),
            solo_sum_ms=round(solo_ms, 4),
            plain_ms=round(p_ms, 3), bound_ms=bound_ms, bound_by=bound_by)
        print("serve_kernel", json.dumps(line), flush=True)
        if timing is None:
            timing = dict(serve_case=label, serve_ms=round(k_ms, 4),
                          serve_device_ms=dev_ms,
                          serve_solo_sum_ms=round(solo_ms, 4),
                          serve_plain_ms=round(p_ms, 3),
                          serve_bound_ms=bound_ms, serve_bound_by=bound_by,
                          serve_clusters=plan.clusters,
                          serve_waves=plan.waves,
                          serve_unpacked_ms=round(u_ms, 4),
                          serve_unpacked_device_ms=u_dev_ms,
                          serve_unpacked_clusters=unpacked.clusters)
        if label == "mixed8":
            timing.update(mixed8_ms=round(k_ms, 4),
                          mixed8_device_ms=dev_ms,
                          mixed8_clusters=plan.clusters,
                          mixed8_waves=plan.waves,
                          mixed8_unpacked_ms=round(u_ms, 4),
                          mixed8_unpacked_device_ms=u_dev_ms,
                          mixed8_unpacked_waves=unpacked.waves)
        del stores, st0, st_k, st_p, st_u, it
    return timing, max_err


def serve_requests():
    """The 16 jobs of ``serve_main``, in submission order (the kinds
    interleaved): single, late, dual and priority north-star shapes at
    seeds 0-3 (seed 0 is each deployment's tracked draw).  Returns
    ``[(kind, seed, JobRequest), ...]``."""
    from waffle_con_tpu_torch import CdwfaConfigBuilder
    from waffle_con_tpu_torch.serve import JobRequest
    from waffle_con_tpu_torch.utils.example_gen import (
        generate_priority_test,
        generate_test,
    )

    def cfg(**kw):
        b = CdwfaConfigBuilder().backend("torch").device("cuda")
        for k, v in kw.items():
            b = getattr(b, k)(v)
        return b.build()

    out = []
    for seed in range(4):
        if seed == 0 and "single" in BASELINE:
            reads = BASELINE["single"]["reads"]  # main's draw, seed 0
        else:
            _t, reads = generate_test(4, 10000, 256, 0.01, seed=seed)
        out.append(("single", seed, JobRequest(
            "single", tuple(reads), config=cfg(min_count=64,
                                               initial_band=216))))
        late = _cut_late(reads, (1000, 5000))
        out.append(("late", seed, JobRequest(
            "single", tuple(r for r, _o in late),
            offsets=tuple(o for _r, o in late), config=cfg(**LATE_CFG))))
        _t1, _t2, dreads = dual_north_star(seed=seed)
        out.append(("dual", seed, JobRequest(
            "dual", tuple(dreads), config=cfg(min_count=16,
                                              initial_band=116))))
        _t0, _h, chains = generate_priority_test(
            32, 2000, 0.01, seeds=(3 + seed, 4 + seed, 200 + 32 * seed))
        out.append(("priority", seed, JobRequest(
            "priority", tuple(tuple(c) for c in chains),
            config=cfg(**PRIORITY_CFG))))
    return out


def _serve_key(kind, res):
    if kind == "dual":
        return _dual_key(res)
    if kind == "priority":
        return _priority_key(res)
    return [(c.sequence, list(c.scores)) for c in res]


#: the serving pool of ``serve_main``: sized for its 16 jobs
SERVE_POOL = dict(ragged_rows=4096, ragged_page=8, ragged_e=256,
                  ragged_l=10240, ragged_c=12288, ragged_gang=8)


def _launch_counts():
    """Every kernel's launches and every plain twin's calls so far."""
    from waffle_con_tpu_torch.ops import arena_kernel as ak
    from waffle_con_tpu_torch.ops import branch_kernel as bk
    from waffle_con_tpu_torch.ops import ragged_kernel as rgk
    from waffle_con_tpu_torch.ops import replay_kernel as rpk
    from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
    from waffle_con_tpu_torch.ops import run_kernel as rk

    launches = dict(
        run_extend=rk.run_extend_cuda.launches,
        run_extend_dual=rdk.run_extend_dual_cuda.launches,
        arena=ak.arena_cuda.launches,
        run_ragged=rgk.run_ragged_cuda.launches,
        branch_step=bk.branch_cuda.launches,
        offset_scan=rpk.offset_scan_cuda.launches,
        col_replay=rpk.replay_rows_cuda.launches,
    )
    twins = (rk.run_extend_plain.calls + rdk.run_extend_dual_plain.calls
             + ak.arena_plain.calls + rgk.run_ragged_plain.calls
             + bk.plain_calls() + rpk.offset_scan_plain.calls
             + rpk.replay_rows_plain.calls)
    return launches, twins


#: (kind, seed) -> (the solo unserved result, its warm wall) of
#: ``serve_main``'s jobs; kinds whose seed-0 job was held to C++ there;
#: the in-process service's wall for the 16 jobs
SERVE_SOLO = {}
SERVE_CPP = set()
SERVE_WALL = {}


def _serve_cpp(kind, req):
    """The C++ engine on one of ``serve_requests``' jobs: ``(result as
    plain data, seconds)``."""
    spec = dict(reads=list(req.reads), offsets=(
        list(req.offsets) if req.offsets else None),
        chains=[list(c) for c in req.reads], config=req.config)
    return _cpp_run("single" if kind == "late" else kind, spec)


def phase_serve_main():
    """The in-process serving path on the card: one ``ConsensusService``
    (8 workers, a queue of 16, the pool of :data:`SERVE_POOL`) answers
    :func:`serve_requests`' 16 jobs submitted at once.  Every served
    result must equal the same request run alone, unserved, on
    ``"torch"`` on the card, byte for byte; seed 0 of each kind must also
    equal the C++ engine on the card's host.  Fails unless the gang
    kernel launched with members of two or more jobs and a group spanned
    two or more band widths, on any planner refusal and on any twin call.
    Prints one line: the 16-job wall and the solo walls summed, batch
    and gang occupancy, the pool's counters, probes refused by reason,
    launches by kernel.  Returns the gang kernel's launches."""
    import torch
    from waffle_con_tpu_torch.ops import ragged as ops_ragged
    from waffle_con_tpu_torch.serve import ConsensusService, ServeConfig
    from waffle_con_tpu_torch.serve.service import _build_engine

    t0 = time.perf_counter()
    reqs = serve_requests()
    gen_s = time.perf_counter() - t0

    def solo_pass():
        got, walls = [], []
        for kind, _seed, req in reqs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = _build_engine(req).consensus()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            got.append(_serve_key(kind, res))
        return got, walls

    cfg = ServeConfig(workers=8, queue_limit=16, **SERVE_POOL)
    ops_ragged.reset_arena()
    launches0, twins0 = _launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with ConsensusService(cfg) as svc:
        handles = svc.submit_all([req for _k, _s, req in reqs])
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        SERVE_WALL["s"] = serve_s
        stats = svc.stats()
        counters = [h.search_report.dispatch_counts if h.search_report
                    else {} for h in handles]
    launches1, twins1 = _launch_counts()
    launches = {k: launches1[k] - launches0[k] for k in launches1}
    twins = twins1 - twins0
    # each request alone, unserved, after the service (warm)
    want, warm_walls = solo_pass()
    for (kind, seed, _req), w, wall in zip(reqs, want, warm_walls):
        SERVE_SOLO[(kind, seed)] = (w, wall)
    for (kind, seed, _req), res, w in zip(reqs, results, want):
        if _serve_key(kind, res) != w:
            raise AssertionError(f"serve_main: {kind} seed {seed}: the "
                                 "served result != the solo result")
    cpp = {}
    for (kind, seed, req), w in zip(reqs, want):
        if seed != 0:
            continue
        got, cpp_s = _serve_cpp(kind, req)
        if got != w:
            raise AssertionError(f"serve_main: {kind} seed 0 != C++")
        cpp[kind] = round(cpp_s, 3)
        SERVE_CPP.add(kind)
    pool, disp = stats["ragged"], stats["dispatch"]
    refusals = {k: sum(c.get(k, 0) for c in counters) for k in PLAN_KEYS}
    line = dict(
        card=smi_line(), jobs=len(reqs), workers=cfg.workers,
        gen_s=round(gen_s, 3),
        serve_wall_s=round(serve_s, 3),
        solo_warm_sum_s=round(sum(warm_walls), 3),
        solo_warm_s={f"{k}{s}": round(w, 3)
                     for (k, s, _r), w in zip(reqs, warm_walls)},
        batches=disp["batches"],
        mean_batch_occupancy=round(disp["mean_batch_occupancy"], 3),
        routed=disp["routed_requests"], direct=disp["direct_dispatches"],
        ragged_groups=disp["ragged_groups"],
        ragged_members=disp["ragged_members"],
        pool={k: pool[k] for k in (
            "groups", "members", "mean_occupancy", "occupancy_max",
            "mixed_w_groups", "admits", "releases", "exhausted",
            "recenters", "injected_consumed", "injected_dropped",
            "launches", "group_failures", "plan_refused", "pages_used")},
        probes_refused=pool["refused"], launches=launches,
        **refusals, twin_calls=twins, cpp_s=cpp,
        jobs_done=stats["jobs"]["done"],
    )
    print("serve_main", json.dumps(line), flush=True)
    if stats["jobs"]["done"] != len(reqs):
        raise AssertionError(f"serve_main: jobs {stats['jobs']}")
    if twins:
        raise AssertionError(f"serve_main: {twins} twin calls")
    if any(refusals.values()) or pool["plan_refused"]:
        raise AssertionError(f"serve_main: planner refusals {refusals}")
    if pool["group_failures"]:
        raise AssertionError("serve_main: a gang launch failed")
    if not launches["run_ragged"] or not pool["groups"]:
        raise AssertionError("serve_main: no cross-job gang launch")
    if not pool["mixed_w_groups"]:
        raise AssertionError("serve_main: no group spanned two band widths")
    if pool["pages_used"]:
        raise AssertionError("serve_main: pages still held after close")
    return launches["run_ragged"]


#: the seeds of ``serve_requests`` that ``replica_main`` serves
REPLICA_SEEDS = (0, 1, 2, 3)
#: the replicated door of ``replica_main``: two replicas of two
#: co-resident shards each on the first card
REPLICA_DEVICES = ("cuda:0",) * 4


def _solo(kind, seed, req):
    """The solo unserved result of one of ``serve_requests``' jobs and its
    wall: ``serve_main``'s when it ran in this process, else run now."""
    import torch
    from waffle_con_tpu_torch.serve.service import _build_engine

    if (kind, seed) in SERVE_SOLO:
        return SERVE_SOLO[(kind, seed)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = _build_engine(req).consensus()
    torch.cuda.synchronize()
    SERVE_SOLO[(kind, seed)] = (_serve_key(kind, res),
                                time.perf_counter() - t)
    return SERVE_SOLO[(kind, seed)]


def _learned_pass(req, want):
    """The seed-0 single job through a learned policy whose perf database
    (a temporary file) holds 3 ``arena`` and 3 slower ``mesh`` records at
    its reads bucket: it must stay on the pool and equal its solo run.
    Returns the pass's numbers."""
    import tempfile

    from waffle_con_tpu_torch.obs import perfdb
    from waffle_con_tpu_torch.parallel import DeviceSet
    from waffle_con_tpu_torch.serve import (
        ConsensusService,
        PlacementPolicy,
        ServeConfig,
    )
    from waffle_con_tpu_torch.serve import placement

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "perfdb.jsonl")
        n = len(req.reads)
        for substrate, wall in (("arena", 1.0), ("mesh", 5.0)):
            for _ in range(placement.MIN_PROFILE_SAMPLES):
                placement.record_outcome(substrate, n, wall, path=path)
        placement.reset_profile_cache()
        policy = PlacementPolicy(large_read_threshold=256, mesh_shards=2,
                                 learned=True, perfdb_path=path)
        cfg = ServeConfig(workers=2, queue_limit=4, placement=policy,
                          **SERVE_POOL)
        with ConsensusService(cfg, device_set=DeviceSet(
                "learned", REPLICA_DEVICES[:2])) as svc:
            got = _serve_key("single", svc.submit(req).result(timeout=600))
            jobs = svc.stats()["jobs"]
        records = perfdb.load_records(path, kind=perfdb.PLACEMENT_KIND)
    if jobs["mesh_placed"] or jobs["placement_errors"]:
        raise AssertionError(f"replica_main learned: jobs {jobs}")
    if got != want:
        raise AssertionError("replica_main learned: the result != solo")
    if len(records) != 2 * placement.MIN_PROFILE_SAMPLES + 1 \
            or records[-1]["substrate"] != "arena":
        raise AssertionError(f"replica_main learned: records {records}")
    return dict(mesh_placed=jobs["mesh_placed"], records=len(records),
                recorded=records[-1]["substrate"],
                bucket=records[-1]["reads_bucket"])


def phase_replica_main():
    """Placement and replicas on the card: ``serve_requests``' jobs at
    :data:`REPLICA_SEEDS` through a ``ReplicatedService`` of two replicas
    over :data:`REPLICA_DEVICES` with a ``PlacementPolicy(256, 2)``.
    Every result must equal its solo run (and seed 0 of each kind the C++
    engine); fails unless the single and late jobs were all placed, both
    replicas routed, the fused sharded step launched with no plain
    partials, a pool ganged two or more jobs, nothing was refused, no
    placement error or twin call happened, and every pool has its pages
    back after ``close()``.  Then the learned pass.  Prints one line;
    returns the launches by kernel."""
    import torch
    from waffle_con_tpu_torch.ops import branch_kernel as bk
    from waffle_con_tpu_torch.ops import ragged as ops_ragged
    from waffle_con_tpu_torch.ops import sharded_scorer as ss
    from waffle_con_tpu_torch.serve import (
        PlacementPolicy,
        ReplicatedConfig,
        ReplicatedService,
        ServeConfig,
    )

    reqs = [r for r in serve_requests() if r[1] in REPLICA_SEEDS]
    solo = [_solo(kind, seed, req) for kind, seed, req in reqs]
    placeable = sum(kind in ("single", "late") for kind, _s, _r in reqs)
    policy = PlacementPolicy(large_read_threshold=256, mesh_shards=2)
    cfg = ReplicatedConfig(
        replicas=2, devices=REPLICA_DEVICES,
        base=ServeConfig(workers=8, queue_limit=16, placement=policy,
                         **SERVE_POOL))
    ops_ragged.reset_arena()
    launches0, twins0 = _launch_counts()
    fused0, shard0 = bk.branch_cuda.fused_launches, ss.shard_step.launches
    partials0 = ss.partials_plain.calls
    torch.cuda.synchronize()
    t = time.perf_counter()
    with ReplicatedService(cfg) as door:
        handles = door.submit_all([req for _k, _s, req in reqs])
        results = [h.result(timeout=900) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        stats = door.stats()
        arenas = [rep.arena for rep in door._replicas]
        counters = [h.search_report.dispatch_counts if h.search_report
                    else {} for h in handles]
        served_by = [h.trace.trace_id.split("/")[0] for h in handles]
    pools = [a.stats() for a in arenas]  # after close()
    launches1, twins1 = _launch_counts()
    launches = {k: launches1[k] - launches0[k] for k in launches1}
    twins = twins1 - twins0
    fused = bk.branch_cuda.fused_launches - fused0
    shard_steps = ss.shard_step.launches - shard0
    partials = ss.partials_plain.calls - partials0
    launches["sharded_col_step"] = shard_steps
    for (kind, seed, _req), res, (w, _wall) in zip(reqs, results, solo):
        if _serve_key(kind, res) != w:
            raise AssertionError(f"replica_main: {kind} seed {seed}: the "
                                 "served result != the solo result")
    cpp = {}
    for (kind, seed, req), (w, _wall) in zip(reqs, solo):
        if seed != 0 or kind in SERVE_CPP:
            continue
        got, cpp_s = _serve_cpp(kind, req)
        if got != w:
            raise AssertionError(f"replica_main: {kind} seed 0 != C++")
        cpp[kind] = round(cpp_s, 3)
    learned = _learned_pass(reqs[0][2], solo[0][0])
    jobs = stats["jobs"]
    refusals = {k: sum(c.get(k, 0) for c in counters) for k in PLAN_KEYS}
    per_replica = [dict(
        replica=r["replica"], routed=r["routed"],
        mesh_placed=r["jobs"]["mesh_placed"], done=r["jobs"]["done"],
        kinds=sorted({f"{k}{s}" for (k, s, _r), by in zip(reqs, served_by)
                      if by == r["replica"]}),
        pool={k: p[k] for k in (
            "groups", "members", "occupancy_max", "mixed_w_groups",
            "admits", "releases", "pages_used", "launches",
            "group_failures", "plan_refused")},
        probes_refused=p["refused"])
        for r, p in zip(stats["replicas"], pools)]
    line = dict(
        card=smi_line(), jobs=len(reqs), seeds=list(REPLICA_SEEDS),
        replicas=len(pools), devices=list(REPLICA_DEVICES),
        serve_wall_s=round(wall, 3),
        solo_warm_sum_s=round(sum(w for _k, w in solo), 3),
        mesh_placed=jobs["mesh_placed"],
        placement_errors=jobs["placement_errors"],
        per_replica=per_replica, launches=launches,
        fused_branch_launches=fused, partials_plain_calls=partials,
        **refusals, twin_calls=twins, cpp_s=cpp,
        cpp_checked_by_serve_main=sorted(SERVE_CPP),
        learned=learned, jobs_done=jobs["done"],
    )
    print("replica_main", json.dumps(line), flush=True)
    if jobs["done"] != len(reqs) or jobs["failed"]:
        raise AssertionError(f"replica_main: jobs {jobs}")
    if jobs["mesh_placed"] != placeable or jobs["placement_errors"]:
        raise AssertionError(f"replica_main: placed {jobs['mesh_placed']} "
                             f"of {placeable}, errors "
                             f"{jobs['placement_errors']}")
    if not all(r["routed"] for r in stats["replicas"]):
        raise AssertionError("replica_main: a replica routed no job")
    if not fused or not shard_steps or partials:
        raise AssertionError(f"replica_main: fused launches {fused}, shard "
                             f"steps {shard_steps}, plain partials "
                             f"{partials}")
    if twins:
        raise AssertionError(f"replica_main: {twins} twin calls")
    if any(refusals.values()) or any(p["plan_refused"] for p in pools):
        raise AssertionError(f"replica_main: planner refusals {refusals}")
    if any(p["group_failures"] for p in pools):
        raise AssertionError("replica_main: a gang launch failed")
    if not launches["run_ragged"] or not any(
            p["groups"] and p["occupancy_max"] >= 2 for p in pools):
        raise AssertionError("replica_main: no cross-job gang launch")
    for p in pools:
        if p["admits"] != p["releases"] or p["pages_used"]:
            raise AssertionError(f"replica_main: a pool kept pages {p}")
    return launches


#: ``cache_main``'s first service: ``serve_main``'s pool geometry with the
#: consensus cache on (its ``cache_dir`` a temporary directory)
CACHE_SNAPSHOT_S = 0.25
#: the checkpoint tier's service snapshots at every poll
CACHE_CKPT_SNAPSHOT_S = 0.0001


def _reversed_request(req):
    """``req`` with its reads (and offsets) in reverse order."""
    import dataclasses

    return dataclasses.replace(
        req, reads=tuple(reversed(req.reads)),
        offsets=(tuple(reversed(req.offsets)) if req.offsets else None))


def _reversed_key(kind, key):
    """The solo result ``key`` (``_serve_key`` form) as a search of the
    reversed reads gives it: every per-read score vector reversed (a dual
    result's per-side vectors too, since reversing keeps each side's
    reads in reversed relative order)."""
    if kind == "dual":
        rev = lambda c: None if c is None else (c[0], c[1][::-1])  # noqa: E731
        return [(rev(c1), rev(c2), s[::-1], a[::-1], b[::-1])
                for c1, c2, s, a, b in key]
    if kind == "priority":
        return key
    return [(seq, scores[::-1]) for seq, scores in key]


def _cache_cpp(req, want, where):
    """The C++ engine on a single job's reads must equal ``want``."""
    got, cpp_s = _cpp_run("single", dict(
        reads=list(req.reads), offsets=None, config=req.config))
    if got != want:
        raise AssertionError(f"cache_main {where}: the result != C++")
    return round(cpp_s, 3)


def _cache_step(svc, req, expect, want, where, wait=600):
    """Submit ``req``, wait for it and check its status against
    ``expect`` and its result against ``want`` (``_serve_key`` form).
    Returns ``(handle, result key, wall s, launches by kernel, submit
    ms)``; fails on any plain twin call."""
    import torch

    launches0, twins0 = _launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    handle = svc.submit(req)
    submit_ms = (time.perf_counter() - t) * 1e3
    res = handle.result(timeout=wait)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches1, twins1 = _launch_counts()
    launches = {k: launches1[k] - launches0[k] for k in launches1}
    if twins1 - twins0:
        raise AssertionError(f"cache_main {where}: {twins1 - twins0} twin "
                             "calls")
    if handle.status.value != expect:
        raise AssertionError(f"cache_main {where}: status "
                             f"{handle.status.value}, expected {expect}")
    kind = "dual" if req.kind == "dual" else (
        "priority" if req.kind == "priority" else "single")
    key = _serve_key(kind, res)
    if want is not None and key != want:
        raise AssertionError(f"cache_main {where}: the result != solo")
    return handle, key, wall, launches, round(submit_ms, 3)


def _add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_cache_main():
    """The consensus cache on the card (``serve/cache``): one
    ``ConsensusService`` of ``serve_main``'s pool geometry with the cache
    on, a ``cache_dir`` in a temporary directory and a snapshot every
    :data:`CACHE_SNAPSHOT_S`, then a second one for the checkpoint tier,
    then a restart.  The seed-0 jobs of :func:`serve_requests` (single
    north star, late, dual, priority):

    1. misses: the four jobs at once, each equal to its solo run, each
       deposited;
    2. exact hits: the same four with the reads reversed (priority in
       chain order), each ``CACHED`` with ``started_at`` None and no
       launch of any kernel, equal to its solo result with the scores in
       the reversed order; the priority job with its chains reversed
       misses;
    3. certified: the single job plus one read equal to its consensus,
       ``CERTIFIED``, equal to its solo search and to C++;
    4. certify failed: the single job plus one read of its truth at 30 %
       error, ``DONE`` with ``certify_failed`` counted, equal to its solo
       search and to C++;
    5. checkpoint tier (a service with ``cache_proposals=False``, a
       snapshot every poll, no ``cache_dir``): the first 255 reads of the
       single job deposit a bound-free snapshot (the phase fails if none
       is), then the 256-read job resumes from it with 1 extra read,
       equal to its solo search and to C++;
    6. restart: a new service on the first ``cache_dir`` serves the
       reversed single job ``CACHED``; a byte of the late job's stored
       entry flipped, the reversed late job is searched ``DONE``, equal,
       the entry quarantined with a ``cache_quarantine`` incident.

    Prints one line; returns the service steps' launches by kernel (the
    solo and C++ reference runs are not counted)."""
    import tempfile

    import numpy as np
    import torch
    from waffle_con_tpu_torch.obs import flight as obs_flight
    from waffle_con_tpu_torch.ops import ragged as ops_ragged
    from waffle_con_tpu_torch.serve import (
        ConsensusService,
        JobRequest,
        ServeConfig,
    )
    from waffle_con_tpu_torch.serve.cache import keys as cache_keys
    from waffle_con_tpu_torch.serve.cache import proposal
    from waffle_con_tpu_torch.serve.service import _build_engine
    from waffle_con_tpu_torch.utils.example_gen import corrupt

    reqs = {kind: req for kind, seed, req in serve_requests() if seed == 0}
    solo = {kind: _solo(kind, 0, req)[0] for kind, req in reqs.items()}
    single = reqs["single"]
    # the single north star's consensus is its truth (``main`` checks it)
    noisy = corrupt(solo["single"][0][0], 0.3, np.random.default_rng(99))

    def solo_of(req):
        torch.cuda.synchronize()
        t = time.perf_counter()
        key = _serve_key("single", _build_engine(req).consensus())
        torch.cuda.synchronize()
        return key, round(time.perf_counter() - t, 3)

    triggered = []

    def on_trigger(reason, _trace_id, detail):
        if reason == "cache_quarantine":
            triggered.append(detail)

    obs_flight.add_trigger_listener(on_trigger)
    total, tiers, cpp = {}, {}, {}
    try:
        with tempfile.TemporaryDirectory() as cache_dir:
            cfg = ServeConfig(workers=8, queue_limit=16, cache=True,
                              cache_dir=cache_dir,
                              checkpoint_interval_s=CACHE_SNAPSHOT_S,
                              **SERVE_POOL)
            ops_ragged.reset_arena()
            with ConsensusService(cfg) as svc:
                # 1. misses, at once
                launches0, twins0 = _launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                order = ("single", "late", "dual", "priority")
                handles = svc.submit_all([reqs[k] for k in order])
                results = [h.result(timeout=600) for h in handles]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                launches1, twins1 = _launch_counts()
                launches = {k: launches1[k] - launches0[k] for k in launches1}
                if twins1 - twins0:
                    raise AssertionError("cache_main misses: twin calls")
                for kind, h, res in zip(order, handles, results):
                    if h.status.value != "done":
                        raise AssertionError(f"cache_main misses: {kind} "
                                             f"{h.status.value}")
                    if _serve_key(kind, res) != solo[kind]:
                        raise AssertionError(f"cache_main misses: {kind} != "
                                             "solo")
                _add_launches(total, launches)
                stats = svc.stats()["cache"]
                if stats["deposits"] != 4 or stats["misses"] != 4:
                    raise AssertionError(f"cache_main misses: cache {stats}")
                tiers["miss"] = dict(status="done", wall_s=round(wall, 3),
                                     launches=launches)

                # 2. exact hits: reversed reads, priority in chain order
                exact = {}
                for kind in order:
                    req = (reqs[kind] if kind == "priority"
                           else _reversed_request(reqs[kind]))
                    h, _key, wall, launches, sub_ms = _cache_step(
                        svc, req, "cached", _reversed_key(kind, solo[kind]),
                        f"exact {kind}")
                    if h.started_at is not None or any(launches.values()):
                        raise AssertionError(
                            f"cache_main exact {kind}: started "
                            f"{h.started_at}, launches {launches}")
                    exact[kind] = dict(wall_ms=round(wall * 1e3, 3),
                                       launches=sum(launches.values()))
                h, _key, wall, launches, _ms = _cache_step(
                    svc, JobRequest("priority", tuple(reversed(
                        reqs["priority"].reads)),
                        config=reqs["priority"].config), "done", None,
                    "exact priority permuted")
                _add_launches(total, launches)
                tiers["exact"] = dict(status="cached", by_kind=exact,
                                      permuted_priority=dict(
                                          status=h.status.value,
                                          wall_s=round(wall, 3)))

                # 3. certified: one extra read equal to the consensus
                plus = JobRequest("single", single.reads + (
                    solo["single"][0][0],), config=single.config)
                want, solo_s = solo_of(plus)
                h, _key, wall, launches, sub_ms = _cache_step(
                    svc, plus, "certified", want, "certified")
                if h.started_at is not None or not launches["branch_step"]:
                    raise AssertionError(f"cache_main certified: launches "
                                         f"{launches}")
                _add_launches(total, launches)
                cpp["certified"] = _cache_cpp(plus, want, "certified")
                # where the pass's host time goes: the same pass again
                # under cProfile, on the entry it certified
                entry = svc._cache._results.get(
                    cache_keys.request_key(single))

                def certify_again():
                    proposal.certify(plus, entry)
                    torch.cuda.synchronize()

                tiers["certified"] = dict(
                    status="certified", pass_ms=sub_ms,
                    wall_s=round(wall, 3), solo_search_s=solo_s,
                    launches=launches,
                    profile=host_profile(certify_again, top=10))

                # 4. certify failed: one read of the truth at 30 % error
                before = svc.stats()["cache"]
                bad = JobRequest("single", single.reads + (noisy,),
                                 config=single.config)
                want, solo_s = solo_of(bad)
                h, _key, wall, launches, sub_ms = _cache_step(
                    svc, bad, "done", want, "certify failed")
                after = svc.stats()["cache"]
                failed = after["certify_failed"] - before["certify_failed"]
                if failed < 1:
                    raise AssertionError("cache_main: no certify failure")
                _add_launches(total, launches)
                cpp["certify_failed"] = _cache_cpp(bad, want,
                                                   "certify failed")
                tiers["certify_failed"] = dict(
                    status="done", certify_failed=failed,
                    # a bound-free snapshot of step 1's single job, when
                    # one was taken, resumes this superset
                    checkpoint_hit=after["checkpoint"] - before["checkpoint"],
                    pass_ms=sub_ms, wall_s=round(wall, 3),
                    solo_search_s=solo_s, launches=launches)
                first_stats = svc.stats()

            # 5. the checkpoint tier
            ckpt_cfg = ServeConfig(
                workers=8, queue_limit=16, cache=True, cache_proposals=False,
                checkpoint_interval_s=CACHE_CKPT_SNAPSHOT_S, **SERVE_POOL)
            ops_ragged.reset_arena()
            with ConsensusService(ckpt_cfg) as svc:
                # all but the last read: 255 of the north star's 256
                cut = JobRequest("single", single.reads[:-1],
                                 config=single.config)
                cut_want, _s = solo_of(cut)
                h, _key, wall_cut, launches_cut, _ms = _cache_step(
                    svc, cut, "done", cut_want, "checkpoint cut")
                _add_launches(total, launches_cut)
                stats = svc.stats()
                if not stats["cache"]["ckpt_deposits"]:
                    raise AssertionError("cache_main: the 255-read job "
                                         "deposited no bound-free snapshot "
                                         f"({stats['checkpoints']})")
                snap = svc._cache._checkpoints.items()[-1][1]["checkpoint"]
                state = snap["body"]["state"]
                h, _key, wall, launches, sub_ms = _cache_step(
                    svc, single, "done", solo["single"], "checkpoint resume")
                _add_launches(total, launches)
                stats = svc.stats()
                if stats["cache"]["checkpoint"] != 1 \
                        or stats["checkpoints"]["resumed"] < 1:
                    raise AssertionError(f"cache_main checkpoint: {stats}")
                cpp["resumed"] = _cache_cpp(single, solo["single"],
                                            "checkpoint resume")
                tiers["checkpoint"] = dict(
                    status="done", snapshot_pops=state.get("pops"),
                    snapshot_entries=len(state["entries"]),
                    snapshot_bytes=len(json.dumps(snap)),
                    cut_wall_s=round(wall_cut, 3),
                    cut_snapshots=stats["checkpoints"]["snapshots"],
                    resume_wall_s=round(wall, 3),
                    resumed=stats["checkpoints"]["resumed"],
                    launches=launches)

            # 6. restart on the first cache_dir, then a corrupt entry
            ops_ragged.reset_arena()
            with ConsensusService(cfg) as svc:
                h, _key, wall_hit, launches, _ms = _cache_step(
                    svc, _reversed_request(single), "cached",
                    _reversed_key("single", solo["single"]),
                    "restart single")
                if any(launches.values()):
                    raise AssertionError(f"cache_main restart: launches "
                                         f"{launches}")
                late = reqs["late"]
                victim = os.path.join(
                    cache_dir, cache_keys.request_key(late) + ".json")
                with open(victim, "rb") as fh:
                    blob = bytearray(fh.read())
                blob[len(blob) // 2] ^= 0x01
                with open(victim, "wb") as fh:
                    fh.write(bytes(blob))
                h, _key, wall, launches, _ms = _cache_step(
                    svc, _reversed_request(late), "done",
                    _reversed_key("late", solo["late"]), "restart late")
                _add_launches(total, launches)
                stats = svc.stats()["cache"]
                quarantined = os.path.exists(os.path.join(
                    cache_dir, "_quarantine", os.path.basename(victim)))
                if stats["quarantined"] != 1 or not quarantined \
                        or not triggered:
                    raise AssertionError(
                        f"cache_main restart: quarantined "
                        f"{stats['quarantined']}, moved {quarantined}, "
                        f"incidents {len(triggered)}")
                tiers["restart"] = dict(
                    status="cached", wall_ms=round(wall_hit * 1e3, 3),
                    quarantined=dict(status="done", wall_s=round(wall, 3),
                                     incidents=len(triggered),
                                     launches=launches))
    finally:
        obs_flight.remove_trigger_listener(on_trigger)
    line = dict(card=smi_line(), tiers=tiers, cpp_s=cpp,
                cache=first_stats["cache"], jobs=first_stats["jobs"],
                checkpoints=first_stats["checkpoints"], launches=total)
    print("cache_main", json.dumps(line), flush=True)
    return total


#: ``procs_main``: two worker processes on the first card, four jobs at a
#: time in each, snapshots every 0.25 s; the drill's one job a worker,
#: snapshots every 0.1 s
PROCS_WORKERS = 2
PROCS_SLOTS = 4
PROCS_SNAPSHOT_S = 0.25
DRILL_SNAPSHOT_S = 0.1
DRILL_JOBS = 8


def procs_worker_main(argv):
    """``chip_smoke.py _procs_worker OUT <worker arguments>``: the port's
    worker process (``serve.procs.worker.main``) under a wrapper that, when
    the worker exits, writes its kernels' launch counts, its plain twins'
    calls, its planner refusals, its serving pool's counters and its peak
    device memory to the JSON file ``OUT`` (a SIGKILLed worker writes
    nothing), with the seconds its imports took and the host seconds its
    searches spent taking snapshots.  Its stdout is the door's stderr."""
    t0 = time.perf_counter()
    out_path, worker_argv = argv[0], argv[1:]
    from waffle_con_tpu_torch.models import checkpoint as ckpt_mod
    from waffle_con_tpu_torch.ops import ragged as ops_ragged
    from waffle_con_tpu_torch.ops import torch_scorer
    from waffle_con_tpu_torch.serve.procs import worker

    import_s = time.perf_counter() - t0
    refused = {"n": 0}
    refuses = torch_scorer.planner_refuses

    def counting(device, planner, *shape):
        got = refuses(device, planner, *shape)
        refused["n"] += int(got)
        return got

    # host seconds in the search threads' snapshots: the body built, its
    # size taken, the wire form attached and the CHECKPOINT frame sent
    snap = {"n": 0, "s": 0.0}
    build = ckpt_mod.CheckpointController._build

    def timed_build(ctrl, builder):
        t = time.perf_counter()
        try:
            return build(ctrl, builder)
        finally:
            snap["n"] += 1
            snap["s"] += time.perf_counter() - t

    torch_scorer.planner_refuses = counting
    ckpt_mod.CheckpointController._build = timed_build
    try:
        rc = worker.main(worker_argv)
    finally:
        import torch

        launches, twins = _launch_counts()
        pool = ops_ragged.arena_stats(ops_ragged.peek_arena())
        with open(out_path + ".tmp", "w") as fh:
            json.dump(dict(
                launches=launches, twin_calls=twins,
                plan_refused=refused["n"], import_s=import_s,
                snapshots=snap["n"], snapshot_s=snap["s"],
                pool={k: pool.get(k) for k in (
                    "groups", "members", "mixed_w_groups", "admits",
                    "releases", "launches", "group_failures",
                    "plan_refused")},
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                max_memory_reserved=torch.cuda.max_memory_reserved(),
            ), fh)
        os.replace(out_path + ".tmp", out_path)
    return rc


class _ProcsLauncher:
    """The ``ProcConfig.launcher`` of ``procs_main``: each worker runs under
    :func:`procs_worker_main`, its counters written to ``<dir>/<name>.json``
    when it exits."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        self.procs = {}

    def out(self, name):
        return os.path.join(self.out_dir, name.replace(":", "_") + ".json")

    def __call__(self, socket_path, name, spec):
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "_procs_worker",
             self.out(name), "--socket", socket_path, "--worker", name,
             "--spec", spec],
            stdin=subprocess.DEVNULL, stdout=2)
        self.procs[name] = proc
        return proc

    def counters(self):
        """Each worker's exit record (``None`` for a worker that wrote
        none: the drill's victim)."""
        out = {}
        for name in self.procs:
            try:
                with open(self.out(name)) as fh:
                    out[name] = json.load(fh)
            except FileNotFoundError:
                out[name] = None
        return out


def _children():
    """Processes whose parent is this one (from ``/proc``)."""
    me, kids = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me:
            kids.append(int(entry))
    return kids


def _card_memory_used_mib():
    return float(smi_line("memory.used").split()[0])


def _sum_launches(records):
    total = {}
    for rec in records:
        if rec is None:
            continue
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def _procs_door(out_dir, slots, snapshot_s):
    """A ``ProcFrontDoor`` of :data:`PROCS_WORKERS` workers on the first
    card with ``serve_main``'s pool geometry, and its launcher (the
    workers' exit records go to ``out_dir``)."""
    from waffle_con_tpu_torch.serve import (
        ProcConfig,
        ProcFrontDoor,
        ServeConfig,
    )

    os.makedirs(out_dir)
    launcher = _ProcsLauncher(out_dir)
    door = ProcFrontDoor(ProcConfig(
        workers=PROCS_WORKERS, worker_slots=slots, queue_limit=16,
        name="procs", launcher=launcher,
        serve=ServeConfig(checkpoint_interval_s=snapshot_s, **SERVE_POOL)))
    return door, launcher


def _procs_jobs(out_dir, reqs, solo, snapshot_s):
    """``serve_requests``' 16 jobs at once through a door of
    :data:`PROCS_WORKERS` workers of :data:`PROCS_SLOTS` slots, a snapshot
    every ``snapshot_s`` (0: none), each result held to its solo run, the
    workers' records checked (``procs_main`` step 1).  Returns the wall,
    the card's memory before and with the workers up, the door's stats,
    the per-worker rows and the launches by kernel."""
    import torch

    mem0 = _card_memory_used_mib()
    door, launcher = _procs_door(out_dir, PROCS_SLOTS, snapshot_s)
    with door:
        torch.cuda.synchronize()
        t = time.perf_counter()
        handles = door.submit_all([req for _k, _s, req in reqs])
        results = [h.result(timeout=900) for h in handles]
        wall = time.perf_counter() - t
        mem_up = _card_memory_used_mib()
        stats = door.stats()
    records = launcher.counters()
    exits = {n: p.returncode for n, p in launcher.procs.items()}
    for (kind, seed, _req), h, res, (w, _wall) in zip(
            reqs, handles, results, solo):
        if h.status.value != "done" or _serve_key(kind, res) != w:
            raise AssertionError(f"procs_main: {kind} seed {seed}: the "
                                 "served result != solo")
    rows = stats["workers"]
    if not all(r["routed"] for r in rows):
        raise AssertionError(f"procs_main: a worker routed no job "
                             f"{[r['routed'] for r in rows]}")
    if any(v != 0 for v in exits.values()) or None in records.values():
        raise AssertionError(f"procs_main: worker exits {exits}")
    launches = _sum_launches(records.values())
    twins = sum(r["twin_calls"] for r in records.values())
    refused = sum(r["plan_refused"] + (r["pool"]["plan_refused"] or 0)
                  for r in records.values())
    if twins or refused:
        raise AssertionError(f"procs_main: twin calls {twins}, planner "
                             f"refusals {refused}")
    if not (launches["run_extend"] and launches["arena"]
            and launches["run_ragged"]):
        raise AssertionError(f"procs_main: launches {launches}")
    if any(r["pool"]["group_failures"] for r in records.values()):
        raise AssertionError("procs_main: a gang launch failed")
    workers = []
    for r in rows:
        rec = records[r["worker"]]
        workers.append(dict(
            worker=r["worker"], start_s=round(r["start_s"], 3),
            import_s=round(rec["import_s"], 3), routed=r["routed"],
            ckpt_frames=r["ckpt_frames"], ckpt_bytes=r["ckpt_bytes"],
            snapshots=rec["snapshots"],
            snapshot_s=round(rec["snapshot_s"], 3),
            launches=rec["launches"], pool_groups=rec["pool"]["groups"],
            mixed_w_groups=rec["pool"]["mixed_w_groups"],
            max_memory_allocated_mib=round(
                rec["max_memory_allocated"] / 2**20, 1),
            max_memory_reserved_mib=round(
                rec["max_memory_reserved"] / 2**20, 1)))
    return dict(wall_s=round(wall, 3), snapshot_every_s=snapshot_s,
                card_memory_used_mib=dict(before=mem0, workers_up=mem_up),
                checkpoints=stats["checkpoints"], per_worker=workers,
                launches=launches)


def phase_procs_main():
    """Out-of-process serving on the card (``serve/procs``): a
    ``ProcFrontDoor`` whose workers are processes of their own, each with
    its own CUDA context on the first card.

    1. :data:`PROCS_WORKERS` workers of :data:`PROCS_SLOTS` slots with
       ``serve_main``'s pool geometry, a snapshot every
       :data:`PROCS_SNAPSHOT_S`, answer :func:`serve_requests`' 16 jobs
       submitted at once.  Every result, decoded from the wire, must equal
       the same request run alone in process on ``"torch"`` (``serve_main``'s
       when it ran), seed 0 of each kind the C++ engine.  Fails unless both
       workers routed jobs, the workers' counters show ``run_extend``,
       ``arena`` and the gang kernel's cross-job launches, and no twin call,
       planner refusal or failed job happened.  Then the same with no
       snapshot: what the snapshots cost.
    2. The SIGKILL drill: :data:`DRILL_JOBS` copies of the dual north star's
       seed-0 job on workers of one slot, a snapshot every
       :data:`DRILL_SNAPSHOT_S`; once a worker has streamed a ``CHECKPOINT``
       frame of a job it runs, it gets ``SIGKILL``.  Every result must
       equal the solo one, the victim must be ``lost``, a started job must
       have migrated with its checkpoint (the survivor's counters show
       column-replay launches: the restore's activations), and exactly one
       ``worker_lost`` incident must fire.
    3. ``close()`` drains; every surviving worker exits 0 and no child
       process is left.

    Prints one line: both 16-job walls beside the solo walls summed and
    ``serve_main``'s in-process wall, each worker's start (spawn to HELLO)
    and imports, jobs routed, snapshots and their host seconds, launches
    by kernel and peak device memory, the card's memory with the workers
    up, CHECKPOINT frames and bytes, the drill's detection time (kill to
    ``worker_lost``) and migrations, the card's name and power limit.
    Returns the launches by kernel of every worker that wrote its record
    (the drill's victim does not)."""
    import signal
    import tempfile

    from waffle_con_tpu_torch.obs import flight as obs_flight

    reqs = serve_requests()
    solo = [_solo(kind, seed, req) for kind, seed, req in reqs]
    cpp = {}
    for (kind, seed, req), (w, _wall) in zip(reqs, solo):
        if seed != 0 or kind in SERVE_CPP:
            continue
        got, cpp_s = _serve_cpp(kind, req)
        if got != w:
            raise AssertionError(f"procs_main: {kind} seed 0 != C++")
        cpp[kind] = round(cpp_s, 3)
    lost_at = []

    def on_trigger(reason, _trace_id, _detail):
        if reason == "worker_lost":
            lost_at.append(time.monotonic())

    obs_flight.add_trigger_listener(on_trigger)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # 1. the 16 jobs, with snapshots and without
            served = _procs_jobs(os.path.join(tmp, "jobs"), reqs, solo,
                                 PROCS_SNAPSHOT_S)
            dark = _procs_jobs(os.path.join(tmp, "no_snapshot"), reqs, solo,
                               0.0)

            # 2. the SIGKILL drill
            dual = next(req for kind, seed, req in reqs
                        if kind == "dual" and seed == 0)
            want = solo[[i for i, (k, s, _r) in enumerate(reqs)
                         if k == "dual" and s == 0][0]][0]
            lost_at.clear()
            obs_flight.reset()
            door, drill = _procs_door(os.path.join(tmp, "drill"), 1,
                                      DRILL_SNAPSHOT_S)
            with door:
                t = time.perf_counter()
                handles = door.submit_all([dual] * DRILL_JOBS)
                victim = None
                deadline = time.monotonic() + 600
                while victim is None and time.monotonic() < deadline:
                    victim = next((r for r in door.worker_stats()
                                   if r["ckpt_frames"] and r["started"]),
                                  None)
                    time.sleep(0.005)
                if victim is None:
                    raise AssertionError("procs_main drill: no checkpoint "
                                         f"{door.worker_stats()}")
                killed_at = time.monotonic()
                os.kill(victim["pid"], signal.SIGKILL)
                results = [h.result(timeout=900) for h in handles]
                drill_wall = time.perf_counter() - t
                drill_stats = door.stats()
            drill_exits = {n: p.returncode for n, p in drill.procs.items()}
            drill_records = drill.counters()
            drill_rows = {r["worker"]: r for r in drill_stats["workers"]}
            survivor = next(n for n in drill_rows if n != victim["worker"])
            if any(_serve_key("dual", r) != want for r in results):
                raise AssertionError("procs_main drill: a result != solo")
            if drill_rows[victim["worker"]]["state"] != "lost" \
                    or not drill_rows[victim["worker"]]["migrations"]:
                raise AssertionError(f"procs_main drill: {drill_rows}")
            incidents = [i for i in obs_flight.incidents()
                         if i["reason"] == "worker_lost"]
            if len(incidents) != 1 or not lost_at:
                raise AssertionError(f"procs_main drill: {len(incidents)} "
                                     "worker_lost incidents")
            if drill_exits[survivor] != 0 or drill_records[survivor] is None:
                raise AssertionError(f"procs_main drill: exits {drill_exits}")
            surv = drill_records[survivor]
            if not surv["launches"]["col_replay"] or surv["twin_calls"] \
                    or surv["plan_refused"]:
                raise AssertionError(f"procs_main drill: survivor {surv}")
    finally:
        obs_flight.remove_trigger_listener(on_trigger)
    left = _children()
    if left:
        raise AssertionError(f"procs_main: child processes left {left}")
    total = _sum_launches([served, dark, surv])
    line = dict(
        card=smi_line(), jobs=len(reqs), workers=PROCS_WORKERS,
        slots=PROCS_SLOTS,
        solo_sum_s=round(sum(w for _r, w in solo), 3),
        in_process_wall_s=(round(SERVE_WALL["s"], 3) if SERVE_WALL
                           else None),
        served=served, no_snapshot=dark, cpp_s=cpp,
        drill=dict(
            jobs=DRILL_JOBS, wall_s=round(drill_wall, 3),
            victim=victim["worker"], victim_exit=drill_exits[victim["worker"]],
            detect_s=round(lost_at[0] - killed_at, 4),
            migrations=drill_rows[victim["worker"]]["migrations"],
            requeues=drill_rows[victim["worker"]]["requeues"],
            restarts=drill_rows[victim["worker"]]["restarts"],
            checkpoints=drill_stats["checkpoints"],
            survivor_launches=surv["launches"]),
        drill_exits=drill_exits,
    )
    print("procs_main", json.dumps(line), flush=True)
    return total


def kernel_row(name, source, replaces, check, launches, status=None):
    """One kernel's entry of the kernel table, from its kernel phase's
    ``(timing, max_err)`` and its launch count on each main path that ran
    (``launches``: path -> count, ``None`` where the phase did not run).
    A timing's other numbers (the gang's summed solo launches, its
    co-resident clusters) ride along."""
    timing, max_err = check or (None, None)
    timing = dict(timing or {})
    ran = {path: n for path, n in launches.items() if n is not None}
    row = dict(
        name=name, route="cuda", source="waffle_con_tpu_torch/csrc/" + source,
        replaces="waffle_con_tpu/" + (
            replaces if "/" in replaces else "ops/" + replaces),
        launches=sum(ran.values()) if ran else None, launches_by_path=ran,
        max_abs_err=max_err, ms=timing.pop("ms", None),
        plain_ms=timing.pop("plain_ms", None),
        bound_ms=timing.pop("bound_ms", None),
        bound_by=timing.pop("bound_by", None), library_ms=None,
    )
    timing.pop("steps", None)
    row.update(timing)
    if status is not None:
        row["status"] = status
    return row


def _with_shards(check, name):
    """A kernel's ``(timing, max_err)`` with its shard instance's
    ``mesh_kernel`` numbers beside it (keys ``shard_instance_*``) and the
    larger max error."""
    if name not in MESH_RUN_CHECKS:
        return check
    numbers, err = MESH_RUN_CHECKS[name]
    timing, max_err = check or (None, None)
    return (dict(timing or {}, **(numbers or {}),
                 shard_instance_max_abs_err=err),
            err if max_err is None else max(err, max_err))


def _merge_checks(gang, serve):
    """The gang kernel's row numbers: ``gang_kernel``'s (the frontier
    gang's launch) with ``serve_kernel``'s cross-store launch beside them
    (its keys ``serve_*``), the larger max error."""
    if serve is None:
        return gang
    if gang is None:
        timing, err = serve
        return dict(timing, ms=timing["serve_ms"],
                    plain_ms=timing["serve_plain_ms"],
                    bound_ms=timing["serve_bound_ms"],
                    bound_by=timing["serve_bound_by"]), err
    return dict(gang[0] or {}, **(serve[0] or {})), max(gang[1], serve[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--phases",
        default="kernel,main,oracle,dual_kernel,dual_main,dual_oracle,"
                "priority_main,priority_oracle,replay_kernel,late_main,"
                "late_oracle,arena_kernel,native_baseline,plan_gate,"
                "gang_kernel,gang_main,branch_kernel,checkpoint_main,"
                "obs_main,runtime_main,mesh_kernel,mesh_main,"
                "serve_kernel,serve_main,replica_main,cache_main,"
                "procs_main",
        help="phases after the build, comma-separated")
    ap.add_argument("--small", action="store_true",
                    help="kernel phases on the small geometry only")
    ap.add_argument("--arena", choices=("on", "off"), default="on",
                    help="off: the engines' arena fast path switched off "
                         "(the previous slice's path), for comparisons")
    ap.add_argument("--profile", action="store_true",
                    help="dual_main adds a host profile (cProfile)")
    opts = ap.parse_args(argv)
    phases = opts.phases.split(",")
    global ARENA_OFF, PROFILE
    ARENA_OFF, PROFILE = opts.arena == "off", opts.profile
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    try:
        from waffle_con_tpu_torch.ops import cuda_build
    except ImportError as exc:
        return fail(f"waffle_con_tpu_torch not importable: {exc}")

    smi = smi_line()
    if ARENA_OFF:
        from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer

        TorchScorer.run_arena = None
    t0 = time.perf_counter()
    cuda_build.build(verbose=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_build.build_info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print("device", json.dumps(dict(
        smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        max_sm_clock=smi_line("clocks.max.sm"),
        int32_peak_ops_s=peak_int32_ops_s(),
        build_s=round(build_s, 2),
        nvcc_s=round(cuda_build.build_info["seconds"], 2), ptxas=ptxas,
        cards=torch.cuda.device_count(),
    )), flush=True)

    # the build cache: both libraries checked against the manifest at
    # their first load (verified, sealed, or quarantined and rebuilt)
    from waffle_con_tpu_torch import native
    from waffle_con_tpu_torch.runtime import events
    from waffle_con_tpu_torch.utils import cache

    cuda_build.library()
    native.load_library()
    print("build_cache", json.dumps(dict(
        checks=dict(cache.last_checks),
        manifest=sorted(cache._load_manifest(cuda_build.BUILD_DIR)),
        quarantined=[e["entry"] for e in
                     events.get_events("cache_quarantine")])), flush=True)

    phase_s = {}

    def timed(phase, fn, *a):
        """Run ``fn`` when ``phase`` was asked for; returns its result."""
        if phase not in phases:
            return None
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[phase] = round(time.perf_counter() - t0, 2)
        return out

    run_check, cap_check = (None, None)
    kernel_out = timed("kernel", phase_kernel, opts.small)
    if kernel_out is not None:
        run_check = kernel_out[:2]
        cap_check = (kernel_out[2], kernel_out[1])
    run_launches = timed("main", phase_main)
    timed("oracle", phase_oracle)
    dual_check = timed("dual_kernel", phase_dual_kernel, opts.small)
    dual_launches = timed("dual_main", phase_dual_main) or (None,) * 3
    timed("dual_oracle", phase_dual_oracle)
    prio_launches = timed("priority_main", phase_priority_main) or (None,) * 3
    timed("priority_oracle", phase_priority_oracle)
    # late_main runs first: replay_kernel also holds the deployment's own
    # recorded calls
    late_launches, late_records = (
        timed("late_main", phase_late_main) or ((None,) * 3, None))
    timed("native_baseline", phase_native_baseline)
    scan_check, replay_check = (
        timed("replay_kernel", phase_replay_kernel, opts.small, late_records)
        or (None, None))
    timed("late_oracle", phase_late_oracle)
    arena_check = timed("arena_kernel", phase_arena_kernel, opts.small,
                        ARENA_RECORDS)
    timed("plan_gate", phase_plan_gate)
    gang_check = timed("gang_kernel", phase_gang_kernel, opts.small)
    gang_main_launches = timed("gang_main", phase_gang_main)
    branch_check = timed("branch_kernel", phase_branch_kernel, opts.small)
    ckpt = timed("checkpoint_main", phase_checkpoint_main) or {}
    timed("obs_main", phase_obs_main)
    timed("runtime_main", phase_runtime_main)
    mesh_check = timed("mesh_kernel", phase_mesh_kernel, opts.small)
    mesh_launches, mesh_runs = (timed("mesh_main", phase_mesh_main)
                                or (None, {}))
    serve_check = timed("serve_kernel", phase_serve_kernel, opts.small)
    serve_launches = timed("serve_main", phase_serve_main)
    replica = timed("replica_main", phase_replica_main) or {}
    cached = timed("cache_main", phase_cache_main) or {}
    procs = timed("procs_main", phase_procs_main) or {}
    run_paths = dict(main=run_launches, dual_main=dual_launches[1],
                     priority_main=prio_launches[0],
                     checkpoint_main=ckpt.get("run_extend"),
                     mesh_main=mesh_runs.get("run_extend"),
                     replica_main=replica.get("run_extend"),
                     cache_main=cached.get("run_extend"),
                     procs_main=procs.get("run_extend"))
    sharded = "sharded: one launch for every shard on a card"
    rows = [
        kernel_row("run_extend", "run_extend.cu", "pallas_run.py:495",
                   _with_shards(run_check, "run_extend"), run_paths,
                   status=sharded),
        kernel_row("run_extend_dual", "run_extend_dual.cu",
                   "pallas_run.py:976",
                   _with_shards(dual_check, "run_extend_dual"),
                   dict(dual_main=dual_launches[0],
                        priority_main=prio_launches[1],
                        checkpoint_main=ckpt.get("run_extend_dual"),
                        mesh_main=mesh_runs.get("run_extend_dual"),
                        replica_main=replica.get("run_extend_dual"),
                        cache_main=cached.get("run_extend_dual"),
                        procs_main=procs.get("run_extend_dual")),
                   status=sharded),
        kernel_row("offset_scan", "offset_scan.cu", "jax_scorer.py:2637",
                   scan_check, dict(late_main=late_launches[0],
                                    checkpoint_main=ckpt.get("offset_scan"),
                                    replica_main=replica.get("offset_scan"),
                                    cache_main=cached.get("offset_scan"),
                                    procs_main=procs.get("offset_scan"))),
        kernel_row("col_replay", "col_replay.cu", "jax_scorer.py:773,2688",
                   replay_check, dict(late_main=late_launches[1],
                                      checkpoint_main=ckpt.get("col_replay"),
                                      replica_main=replica.get("col_replay"),
                                      cache_main=cached.get("col_replay"),
                                      procs_main=procs.get("col_replay"))),
        kernel_row("arena", "arena.cu", "jax_scorer.py:1731",
                   _with_shards(arena_check, "arena"),
                   dict({path: ARENA_LAUNCHES.get(path) for path in
                         ("main", "dual_main", "priority_main", "late_main")},
                        checkpoint_main=ckpt.get("arena"),
                        mesh_main=mesh_runs.get("arena"),
                        replica_main=replica.get("arena"),
                        cache_main=cached.get("arena"),
                        procs_main=procs.get("arena")),
                   status=sharded),
        # the megastep is the run kernel under a step cap: its launches
        # are the run kernel's, its numbers the capped launch's
        kernel_row("run_mega", "run_extend.cu", "jax_scorer.py:1272",
                   cap_check, run_paths),
        kernel_row("run_ragged", "run_ragged.cu", "ragged.py:595",
                   _merge_checks(gang_check, serve_check),
                   dict({path: GANG_LAUNCHES.get(path) for path in
                         ("main", "dual_main", "priority_main",
                          "late_main")}, gang_main=gang_main_launches,
                        serve_main=serve_launches,
                        replica_main=replica.get("run_ragged"),
                        cache_main=cached.get("run_ragged"),
                        procs_main=procs.get("run_ragged")),
                   status="redesigned: members packed by their own "
                          "cluster size, a member-scoped st.async exchange "
                          "instead of the cluster barrier"),
        kernel_row("branch_step", "branch_step.cu",
                   "jax_scorer.py:506,537,557,629,683,754,821", branch_check,
                   dict({path: BRANCH_LAUNCHES.get(path) for path in
                         ("main", "dual_main", "priority_main", "late_main",
                          "plan_gate")},
                        checkpoint_main=ckpt.get("branch_step"),
                        replica_main=replica.get("branch_step"),
                        cache_main=cached.get("branch_step"),
                        procs_main=procs.get("branch_step")),
                   status="redesigned: one launch a batch with the band in "
                          "registers (one_launch), else the slab plan"),
        # the shards of a card are one fused branch-step call: its
        # launches are the sharded store's calls on mesh_main
        kernel_row("sharded_col_step", "branch_step.cu",
                   "parallel/mesh.py:284", mesh_check,
                   dict(mesh_main=mesh_launches,
                        replica_main=replica.get("sharded_col_step")),
                   status="redesigned: one fused branch_step.cu launch for "
                          "every shard on a card, the partials summed in "
                          "the kernel"),
    ]
    # every kernel must have launched on some main path that ran (the
    # gang's path is gang_main: on the other paths it engages only where
    # their frontier is flat, and they report how often)
    for row in rows:
        by = row["launches_by_path"]
        if row["name"] == "run_ragged":
            by = {k: v for k, v in by.items()
                  if k in ("gang_main", "serve_main", "replica_main",
                           "procs_main")}
        if by and not sum(by.values()) and not ARENA_OFF:
            return fail(f"{row['name']}: no launch on the main paths "
                        f"{row['launches_by_path']}")
        # every search roots, reads stats and pushes through the branch
        # step: each path that ran launched it
        if row["name"] == "branch_step" and not all(by.values()):
            return fail(f"branch_step: a path without a launch {by}")

    print("phase_seconds", json.dumps(phase_s), flush=True)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["_procs_worker"]:
        sys.exit(procs_worker_main(sys.argv[2:]))
    sys.exit(main())
