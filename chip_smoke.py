#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.  Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card: name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every ``src/repro_torch/csrc/*.cu`` (blur with
   the persistent M1, the preempt flag, flash attention, decode attention,
   RG-LRU scan, RWKV-6, the surrogate LM's persistent M2/M3, the attention
   LM's persistent M4/M5) for
   ``sm_90a``, one process per source, all at
   once, and prints each kernel's register and spill lines;
3. kernel vs plain version on the card: median (bitwise) and gaussian
   (max abs difference <= 1e-6) on runs of 1, 7 and 8 row blocks at width
   4096 and one block at widths 128, 130 and 129 (``BLUR_CHECKS``), then a
   whole 3-iteration median image run through the task code;
4. main path: ``repro_torch.Client(n_regions=2)`` on cuda:0 serves two
   priority-4 MedianBlur tasks (iters=3) on 16-megapixel frames; once both
   have retired a chunk a priority-0 GaussianBlur arrives and preempts one.
   Results must equal the plain version run on the card.  The kernel's
   row-block counter, zeroed just before, must read sum(iters x 128)
   exactly after (every row block ran once through the kernel), and its
   launch counter at least ceil(row blocks / budget) a kind and at most 2
   per chunk retired (the task layer launches one run of row blocks per
   pass a chunk touches);
5. times after warm-up at the main path's launch shape ([258, 4098] -> [256,
   4096], 8 row blocks) and at one row block ([34, 4098]), per launch, per
   row block and per whole image of 16 runs: device time from
   ``torch.profiler`` (the JSON's numbers; where it missed the launches,
   the time queued behind a spin kernel) and back-to-back wall time from
   CUDA events, for the kernel, its plain version and (gaussian) one
   ``conv2d`` call at the run shape, beside the memory bound, and the run
   under each of the kernel's rows per thread (1, 2, 4, 8); then the main
   path's workload once more without the injected slowdown, end to end,
   and the host<->device copies one task pays outside its chunks;
5a. elastic pool: ``repro_torch.Client(backend=Scheduler(Shell(n_regions=1),
   pool=RegionPool(shell, min_regions=1, max_regions=2)))`` on cuda:0
   (``POOL_BURST``): at the first chunk boundary of the first priority-4
   MedianBlur (iters=3) the rest of the burst is submitted,
   ``request_grow()`` must bring the pool to 2 regions (a second CUDA
   stream) and ``request_shrink(rid)`` drains the region running that
   task: it is checkpoint-preempted, requeued, finished on the survivor
   (through the retired region's committed bank), and its (ping, pong)
   must equal an unpreempted run of the port bitwise; then a priority-0
   GaussianBlur arrives.  Row blocks exactly sum(iters x 128); one grow and
   one shrink; prints ``grows``, ``shrinks``, ``resize_events``,
   ``region_seconds`` and ``utilization`` from ``report()["pool"]``;
5b. the deprecated ``Controller`` on cuda:0 (two regions): a priority-1
   MedianBlur (iters=2) and a priority-3 GaussianBlur, ``run()``, then
   ``wait()``; both equal the plain version, row blocks exact;
5c. the preemption overhead (the paper's metric i and its §6.3 headline):
   one seeded stream in the reference harness's mix (MedianBlur over 1/2/3
   iterations and GaussianBlur, 5 priorities, seed 15; 12 tasks at 4096^2,
   arrivals uniform over ``OVERHEAD_SPAN_S``) through ``Scheduler.run`` at
   1 and 2 regions, preemption off, on, on, off at each, twice
   (``OVERHEAD_ROUNDS``), both bitstreams prewarmed; every image equal to
   the plain version's, row blocks exactly 16 x sum(iters x 128); prints
   each arm's tasks/s, preemptions, urgent (priority <= 1) service p50/p99
   and the serving window a task, then the overhead 1 - tput(on) /
   tput(off) over all arms and by round (the rounds' spread is the
   noise), beside the paper's FPGA 1.66 % (1 region) and 4.04 % (2
   regions);
5d. flight recorder (``repro_torch.obs``): the main path's workload (4)
   without the injected slowdown, with a ``Tracer``, a ``MetricsRegistry``
   and a sampling ``TelemetryMonitor`` threaded through ``Client``.  The
   trace must hold submit, queue, dispatch, reconfig, icap, run, chunk,
   preempt_request, preempt_honored and done; one chunk event per retired
   chunk; nothing dropped; 3 tasks and at least one preemption response in
   ``report()["trace"]``; the registry's ``preemptions_total`` equal to the
   report's; every image equal to the plain version's, row blocks exact;
   and its Chrome trace, written to a temporary file, must pass
   ``tools/trace_report.py``.  Prints the trace's per-region occupancy,
   the median wall time and host time per chunk of 3 untraced and 3
   traced runs, alternated, the emit cost of the tracer, and the card's
   busy share over the same workload under ``torch.profiler`` (the union
   of its kernel and copy intervals from the first submission to the last
   result) and how long uploads and result copies ran at once;
5e. the megakernel engine (``[mega]``) and M1, the persistent blur kernel
   (one cooperative launch per task; a watcher block reads the region's
   mapped preempt flag one chunk boundary ahead): (1) M1 against its plain
   version on the card (the host loop through ``make_pipelined_chunk`` with
   B1), both kinds, sizes 30 (padded to 128), 256 and 4096, budgets 1, 2, 3
   and 8, a whole 3-iteration task in one launch (its row blocks and
   grid-wide waits checked against ``mega_plan`` by the wrapper); the flag at every boundary of the
   small task (boundary 1 of every launch, then each boundary of a fresh
   launch and its resume) and at random boundaries of a 4096^2 task,
   resuming each time: after every exit the context words and chunk count
   equal, the images bitwise (median) or within 1e-6 (gaussian), the row
   blocks and the progress word exact; (2) a host ``request_preempt()``
   30 % into a 4096^2 task of 100 iterations at budget 1: the launch exits
   on the flag at most 2 chunks after the boundary the device had
   published when the write was done (its progress word, read right
   after the write), the host sees the exit within one chunk + its
   1 ms poll sleep + 2 ms of wake slack, and the resumed task equals the
   plain version; (3) ``inject_failure()`` mid-flight: the launch pops as
   promptly and the task recovers on the other region, bitwise; (4) the
   main path's workload (4, no slowdown) through
   ``Client(n_regions=2, engine="megakernel")``, the priority-0 arrival
   placed at the background launches, preempting through the flag: images
   equal the plain version, row blocks exact, M1 launched and B1 never,
   ``megakernel_launches`` and ``flag_poll_exits`` nonzero; then 3
   megakernel and 3 pipelined runs alternated (medians and ranges of wall
   time, host time per task and urgent service), and one more megakernel
   run under ``torch.profiler``: the card's busy share and how long
   uploads and result copies ran at once (5d prints both for the
   pipelined engine); (5) ``blur_latency_probe``'s parts of a chunk at
   budgets 1 and 8 (a pass's run, a grid sync, the earlier boundary, the
   watcher's flag read, a hand-off round), then M1's device time per
   chunk and per task at budgets 1 and 8 (``torch.profiler``, by kernel
   name; else queued behind a spin kernel), each kind timed twice, beside
   B1's 8-block run, the bound, the plain version and, for gaussian,
   ``conv2d`` over a chunk's rows, with the grid and its cap; a flag
   written into a running budget-1 launch (``MEGA_LAG_TRIALS`` trials, at
   most 2 chunks past the progress read after the write); and two
   regions' launches on two streams at once against one alone, with how
   long each pair ran at once on the card (the
   medians of 21 interleaved reps each, less than 1.75x, where one after
   the other takes 2x);
5f. the cluster fabric and the checkpoint store (``[cluster]``): two
   shells of one region each on cuda:0 behind ``ClusterFrontend``
   (``chunk_budget=8``, 4096^2 f32 frames): (1) the main path's mix
   routed over both shells (placement and the report's cluster keys
   printed; images equal the plain version, row blocks exact); (2) a
   forced running migration of a MedianBlur (3 iterations) from shell 0
   to shell 1 at a chunk boundary placed with ``on_chunk``, through the
   checksummed disk spill: one migration, the spill CRC-verified, (ping,
   pong) bitwise an unpreempted run of the port, row blocks exact, and
   the hop's split on the host clock (request -> handoff,
   ``materialize``, ``save_pytree``, ``load_pytree``, resubmit -> first
   chunk on the destination) with the spill's bytes; (3) the same hop in
   megakernel mode: M1 preempted through the flag after its first chunk
   (``on_launch`` holds the launch until the migrator has asked), resumed
   on shell 1, bitwise, B1 never launched; (4) ``inject_failure()`` on
   shell 0 at its task's 4th chunk boundary: every handle resolves, none
   lost or stranded, every image bitwise, the killed task's re-run row
   blocks at most the 5 chunks it had launched (times from the injection
   to the re-admission and to its first chunk on the survivor); (5) the
   ``[overhead]`` stream as one 12-task burst through 1 shell, 2 shells,
   and 2 shells with one forced migration (the reference's
   ``measure_cluster`` arms): turnaround p50/p99 of each, the p99 ratio,
   ``migrated_bit_identical``; correctness asserted, no speed;
5g. the surrogate LM's persistent kernels and the serve CLI's subcommands
   (``[decode]``), at the surrogate's published scale (d_model 384, vocab
   51865): (1) M2 (``seq_prefill_mega``) and M3 (``seq_decode_mega``)
   against their plain versions (the host loop over the task body, on the
   card) with the flag at every boundary of a small task at budgets 1, 2
   and 4, then at random boundaries of tasks at the main path's shapes (a
   128-token prompt; 32 slots of an 8-token round): context words, chunk
   counts, the progress word and every buffer bitwise; (2) the main path:
   ``repro_torch.launch.serve.serve_decode`` at 64 sequences, 32 slots,
   8-token rounds, prompts 2-128, 2-64 new tokens, a probe every 3rd round,
   megakernel: every stream equal to the oracle, the M2/M3 counts (zeroed
   just before) exactly one a prefill and one a round dispatch, at least
   one round exited on the flag; the same pipelined (no M2/M3 launch); the
   reference's defaults (6 sequences) pipelined, megakernel, megakernel,
   pipelined; the attention LM
   pipelined once; ``serve_task_stream`` and ``serve_cluster`` at 4096^2 in
   megakernel mode (images equal the plain version, M1 launched, B1
   never); (3) tokens/s and TTFT p50/p99 at the main shape without probes,
   pipelined, megakernel, megakernel, pipelined; (4) M2/M3's device time a
   launch and a chunk at budgets 1 and 2 beside the plain version, the
   bound and the floor of one flag read a chunk, ``seq_latency_probe``'s
   terms (the earlier design's chunk part by part among them), and for
   each a flag write into a running launch (exit at most 2 chunks past the
   progress the host read, the host time to the exit) and a launch armed
   before it starts (exit at boundary 1);
6. flash check: the flash-attention kernel against its plain version at the
   serving prefill shape (q [4, 32, 16, 128], k/v [4, 8, 128, 128] strided
   as the prefill passes them), q_offset 0 / 64 / 112, then at the edges of
   its block plan and staging (``FLASH_EDGES``: groups 1, 8 and 32, hd 8,
   16, 30 and 120, windows, a ragged T and S, 2 and 3 passes of 128 keys),
   without the causal mask (``FLASH_NON_CAUSAL``), and on the serving layout
   shifted by one element (no row 16-byte aligned), f32 (max abs
   difference <= 2e-5) and bf16 (<= 2e-2); with window 0 every row must be
   exactly 0;
7. decode check: the paged decode kernel against its plain version at
   q [8, 32, 1, 128], pools [65, 16, 8, 128], tables [8, 8], per-row
   positions including 0, and the contiguous entry on a ring that wrapped
   (<= 2e-5); then paged against gather-plus-contiguous, bitwise; then the
   same checks at groups 1 and 8 and hd 64 (``DECODE_EDGES``), with and
   without a window;
8. token serving, the attention LM's main path: ``repro_torch.Client(
   n_regions=2, serving={"lm": "attention", ...})`` on cuda:0 at Qwen3-8B's
   attention widths (d_model 4096, vocab 151936, 32 heads, 8 kv heads,
   head dim 128; one attention layer with random weights from seed 7, not
   Qwen3 itself), prefills pinned to region 0 and decode to region 1.
   16 sequences (prompts of 8-96 tokens, 8-32 new tokens, from seed 0);
   every 3rd decode round is preempted at its 2nd chunk through the
   region's ``on_chunk`` hook.  Every stream must equal
   ``attention_oracle_stream`` replayed on the card with the LM's weights,
   at least one round must have been preempted, and the launch counters,
   zeroed just before, must read 8 flash launches per prefill task and 8
   decode launches per decode round.  The same traffic then runs three
   times more, warm, under ``torch.profiler`` (device time by kernel over
   the serving window) and with a ``Tracer`` and a ``MetricsRegistry``
   (the tokens counter must equal the tokens streamed, the TTFT histogram
   count the sequences, the ``decode_round`` spans the engine's rounds),
   and must stream the same tokens;
8a. ``[serve, mega]``, between phase 8's first pass and its repeats: the
   same traffic through ``Client(n_regions=2, serving=SERVING,
   engine="megakernel")``, every 3rd decode round's first launch armed
   through ``on_launch`` to exit at its 2nd boundary.  Every stream must
   equal phase 8's oracle replay, a round must exit on the flag, the
   counters (zeroed just before the first submit, read after the last
   result) must read one M4 launch per prefill task and one M5 launch per
   decode dispatch, together the regions' megakernel launches, and no B2
   or B3 launch; tokens/s and TTFT beside phase 8's.  Then M4 and M5
   (``csrc/attn_lm.cu``) against their plain versions on the card (the
   host loop over the chunk body: cuBLAS f32 products, B2/B3) at phase 8's
   weights and shapes, the flag at every boundary of one task each at
   budgets 1, 2, 4 and 8 (M4 also at the prompts of ``ATTN_EMIT_LENS``)
   and at random boundaries of 3 more: tokens, tables
   and context words bitwise, K/V within 2e-5, with the smallest top-two
   gap of the plain logits among the emitted tokens; their device time a
   launch and a chunk at the main path's budget (``torch.profiler``, else
   queued behind a spin kernel), the plain version's, the bound from the
   bytes and FLOPs each segment or step needs, the grid; and the host time
   from a flag write to a running M5 launch's exit;
9. attention times at those shapes: device time (``torch.profiler``, else
   queued behind a spin kernel) and CUDA-event time per launch for each
   kernel, its plain version and one ``scaled_dot_product_attention`` call
   (explicit boolean mask, GQA) as the yardstick, beside the bound from
   bytes and FLOPs;
10. recurrence check: the RG-LRU scan (B4) and RWKV-6 (B5) kernels against
    their plain versions at the reference's sweep shapes, the edges of the
    kernels' segments, tiles, chunks and column blocks (``SCAN_SHAPES``,
    ``RWKV_SHAPES``) and the serving shapes (B4 [4, 128, 4096] and
    [4, 1, 4096]; B5 [4, 128, 32, 64] and [4, 1, 32, 64]), with a random
    nonzero h0 / s0 and without one (h_seq, h_last within 1e-5; o, s_last
    within 1e-4);
11. ``serve lm`` at full width on cuda:0, ``rwkv6-1.6b`` then
    ``recurrentgemma-9b`` (random weights from seed 0, the depth uncut):
    ``repro_torch.launch.serve.serve`` on 4 prompts of 128 tokens, 32
    greedy tokens each.  The launch counters, zeroed just before, must read
    one B5 launch per RWKV layer per step (24 x 32) and one B4 launch per
    RG-LRU layer per step (26 x 32).  The same weights and prompts are
    replayed with the kernels' plain versions on the card
    (``plain_versions()``) and once more through the kernels: every greedy
    token must be equal and the prefill logits within 1e-3.  Weight-draw
    seconds, prefill seconds, decode tokens/s and peak device memory are
    printed, and the device time by kernel over one traced prefill and one
    traced decode step, with the share of B4/B5 and of the f32 GEMMs and
    the in-path time per launch of B4/B5;
12. recurrence times at the serving shapes: device time (``torch.profiler``;
    a window that missed a kernel launch is profiled again) and CUDA-event
    time per launch for each kernel and its plain version, and the
    kernel's CUDA-event time with its launches queued behind a spin kernel
    (device-bound; used where the profiler never saw a whole window),
    beside the bound from bytes and FLOPs.  Each kernel is timed warm (the
    same inputs again, which stay in the 50 MB L2) and cold (rotating over
    at least three input sets of more than 100 MB together, as the main
    path finds its inputs: written by the projections, not yet read).
    PyTorch has no single call for either recurrence, so the library time
    is null;
13. ``[train]``, the training half, which launches none of B1-B5: RWKV-6
    1.6B at full width and depth in f32 through ``launch/train.py``'s
    ``train_loop`` (batch 8, seq 128, 8 steps, no checkpoint): every loss
    finite and the last below the first, every parameter leaf the model
    reads with a nonzero gradient on the first step (only the unapplied
    gate's ``mu_g``/``wg`` zero, as in the reference) and B4/B5 never
    launched; the step time (median of steps 2-8), tokens/s, the
    model-FLOP share of the f32 peak (``mfu_f32``) and peak memory, with
    the card's SM clock, power draw and temperature sampled by
    ``nvidia-smi`` every 0.5 s through the run; one step more traced by
    ``torch.profiler``: the card's busy share and its time by kernel.  Then
    ``examples/torch_train_100m.py``'s model for 20 steps with a
    checkpoint every 10; 5 straight steps against a crash after step 3's
    checkpoint and a restart (reduced h2o-danube, batch 2, seq 32) within
    1e-5; and ``examples/torch_multi_tenant_serve.py`` on cuda:0: serving
    requests placed by ``on_chunk`` preempt the training task at least
    once, and its final state must equal an uninterrupted run's (rerun
    with deterministic algorithms if it does not; at most 1e-6 then);
14. ``[encdec]``, the encoder-decoder stack and the modality frontends,
    which launch none of B1-B5 (checked): whisper-tiny at full width and
    depth in f32 (4 encoder + 4 decoder layers, d_model 384, vocab 51865,
    seed-0 weights) through ``serve()`` on cuda:0, 4 clips of 1500 frame
    embeddings, prompts of 4 tokens, 64 greedy tokens; the same weights,
    frames and prompts replayed on the CPU (prefill logits within 1e-3,
    streams equal, or where one first differs the CPU's top-two logit gap
    there below 1e-4); teacher-forced decode after a 1-token prefill
    against ``forward`` within 2e-2 with ``cache["enc"]`` bitwise
    unchanged; encode, prefill and decode times, decode tokens/s, peak
    memory and one traced decode step (device time by kernel, busy
    share).  Then 8 train steps (remat "full") at batch 8 x 64 text tokens
    with 1500 frames: every loss finite, the last below the first, every
    leaf with a nonzero finite first-step gradient; step time (median of
    steps 2-8), peak memory.  Then llava-next-34b at full width with 8 of
    its 60 layers (all 60 do not fit one card in f32): batch 2 x (576
    patch embeddings + 64 text tokens), 16 greedy tokens, cache ``pos``
    640, teacher-forced decode against ``forward``; prefill seconds,
    decode tokens/s, peak memory;
15. ``[pod]``, the placement half of the pod tooling, which launches none
    of B1-B5 (checked): ``input_specs`` and the input and output
    shardings of every registry config x ``SHAPES`` cell on both
    production meshes (16x16 and 2x16x16, every entry ``cuda:0``), each
    cell's per-device input bytes and whether it fits one H100 whole;
    then DBRX-132B's MoE layer at full width in f32 (12.7 GB of experts)
    on the 16x16 mesh, single-process binding (256 shards on the card):
    ``moe_ffn`` under ``MOE_MODE="ep_decode"`` on 128 one-token rows, and
    ``moe_ffn`` (TP) and ``moe_ep_ffn`` on 16 x 512 tokens, each within
    1e-4 x max |y| of ``moe_ffn_local`` per data shard (aux within 1e-4
    of the all-token load balance), its body run on all 256 shards; wall
    time and peak memory;
16. ``[dryrun]``, the analysis half of the pod tooling, which launches
    none of B1-B5 (checked): ``repro_torch.launch.dryrun`` on DBRX-132B x
    decode_32k and train_4k (at 2 microbatches, where the cell's default
    is 16 on 16x16 and 8 on 2x16x16: each microbatch is one more pass of
    the 40 layers, which the CLI's sweep runs), Qwen3-8B x prefill_32k and
    RWKV-6 1.6B x long_500k at full size on both production meshes (fake
    process groups
    of 256 and 512 ranks, one child process a record, all at once, the
    card hidden from them), each record ``ok``: per-device bytes, whether
    it fits, flops, bytes, collective bytes by op, the schedule's first
    lines.  Then Qwen3-8B at full width with 4 of its 36 layers in bf16,
    a prefill of 1 x 8192 and a train step of 1 x 4096: each dry-run on a
    1x1 mesh and run for real on cuda:0, the predicted per-device total
    within 10 % of the step's peak (``max_memory_allocated()`` less what
    was allocated before beside its arguments), the dry run's flops equal
    to ``FlopCounterMode``'s on the card, the median step time beside its
    bound max(flops / 989e12, bytes / 3.35e12) and their ratio.

The last three lines of standard output are the kernel JSON record, the
card line, and ``{"ok": true, "device": {...}}``.  The script imports
nothing of the JAX package.  Without CUDA it exits non-zero and prints no
result.

``python3 chip_smoke.py --ab OTHER_TREE`` times the main path's workload
(4, without the injected slowdown, untraced) in OTHER_TREE (an unpacked
``git archive`` of another commit, e.g. the parent) and in this tree, one
process each, in the order other, this, this, other, ``AB_RUNS`` runs
after a warm-up in each: host time per chunk, urgent service and wall
time, then each tree's median and range.  ``python3 chip_smoke.py
--ab-attention OTHER_TREE`` does the same for B2's and B3's device time per
launch at phase 9's shapes, and logs each tree's register and spill lines.
``python3 chip_smoke.py --ab-seq OTHER_TREE`` does the same for M2's and
M3's device time per launch at ``[decode]``'s shapes (a 128-token prompt;
32 slots, an 8-token round) at budgets 1 and 2, each tree's whole task held
against the plain version bitwise, and for the tokens/s and TTFT of
``[decode]``'s A/B workload in megakernel mode without probes.
``python3 chip_smoke.py --ab-mega OTHER_TREE`` does the same for M1's
device time per launch and per chunk of a 3-iteration 4096^2 task at
budgets 1 and 8, both kinds (each tree's task held against the plain
version), B1's 8-block run, and the megakernel arm of ``[mega]``'s main
path (wall, host time per task, urgent service).
``python3 chip_smoke.py --dryrun`` runs the ``[dryrun]`` phase alone.
"""
from __future__ import annotations

import itertools
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SIZE = 4096            # 16-megapixel single-channel frame, padded [4098, 4098]
# B1 checks, (row blocks, width): runs of 1, 7 and 8 blocks at the frame's
# width, one block at 128, at a width that leaves a ragged column block, and
# at an odd one (an odd row stride: 4-byte loads)
BLUR_CHECKS = ((1, 4096), (7, 4096), (8, 4096), (1, 128), (1, 130), (1, 129))
RUN_BLOCKS = 8         # the budget: the row blocks of a main-path launch
BG_ITERS, URGENT_ITERS = 3, 1
SLOWDOWN_S = 0.005     # stretches each chunk so the preemption surely lands
GAUSS_TOL = 1e-6
# [pool]: a burst on a pool grown from 1 to 2 regions, then shrunk back by
# draining the region that runs the first priority-4 task
# (kernel, iterations, priority)
POOL_BURST = (("MedianBlur", 3, 4), ("MedianBlur", 3, 4),
              ("MedianBlur", 3, 4), ("GaussianBlur", 1, 0))
# [overhead]: the reference harness's task mix and seed
# (benchmarks/harness.py:26-38): MedianBlur over 1/2/3 iterations and one
# iteration of GaussianBlur, 5 priorities, seed 15; 12 tasks at 4096^2
HARNESS_MIX = {"MedianBlur": ("MedianBlur", 1),
               "MedianBlur2": ("MedianBlur", 2),
               "MedianBlur3": ("MedianBlur", 3),
               "GaussianBlur": ("GaussianBlur", 1)}
OVERHEAD_SEED = 15
OVERHEAD_TASKS = 12
# arrivals uniform over [0, OVERHEAD_SPAN_S]: a mean spacing of 50 ms, below
# one task's service on an H100, about 100 ms with its pageable copies, so
# the card stays busy (the first arm prints both)
OVERHEAD_SPAN_S = 0.6
OVERHEAD_ROUNDS = 2   # off, on, on, off, twice at each region count
PAPER_OVERHEAD_PCT = {1: 1.66, 2: 4.04}   # FPGA results (PAPER.md §6.3)
MONITOR_INTERVAL_S = 0.05  # the traced runs' telemetry sampling period
TRACE_ROUNDS = 3           # untraced, traced, alternated, 3 times each
TRACE_KINDS = ("submit", "queue", "dispatch", "reconfig", "icap", "run",
               "chunk", "preempt_request", "preempt_honored", "done")
EMITS = 50_000             # emits timed per thread
AB_RUNS = 5                # timed main-path runs per arm of --ab
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# the column-sort median: 4 sorted vertical triples (6 min/max each) shared
# by a thread's 2 outputs, then 12 per output; gaussian 9 mul + 8 add
OPS_PER_PIXEL = {"median": 24, "gaussian": 17}
REPLACES = {"median": "src/repro/kernels/blur/kernel.py:44",
            "gaussian": "src/repro/kernels/blur/kernel.py:50"}
TIMEOUT_S = 300
# [mega]: M1 against its plain version at these sizes (30 pads to 128) and
# budgets, 3 iterations; the flag at every boundary of the small task at
# budget 2 and at random boundaries 1..12 of a 4096^2 task at budget 8
MEGA_SIZES = (30, 256, 4096)
MEGA_BUDGETS = (1, 2, 3, 8)
MEGA_ITERS = 3
MEGA_SMALL_BUDGET = 2
MEGA_RANDOM_MAX = 12
# the mid-flight request and failure: a 4096^2 task of 100 iterations at
# budget 1 (12800 chunks, ~29 ms of M1 on the H100), hit this far into a
# launch; long enough that a host thread's late wake-up (the GIL's 5 ms
# switch interval) still lands the request mid-flight
MEGA_RESPONSE_ITERS = 100
MEGA_REQUEST_AT = 0.3
# the response bound on the host's clock: one chunk's device time, the
# host's longest poll sleep (region._POLL_MAX_S) and the time a shared
# host takes to wake that sleep and read the launch's result
MEGA_WAKE_SLACK_S = 2e-3
# chunks from the host's flag write to the launch's exit, counted on the
# progress word read right after the write: 0 when the launch has already
# exited by then, 1 for the chunk in flight, 2 when the progress word
# itself is a boundary behind (a read crossing the PCIe write of the last)
MEGA_LATE_CHUNKS = 2
MEGA_AB = ("pipelined", "megakernel", "megakernel", "pipelined",
           "pipelined", "megakernel")
MEGA_SIDE_REPS = 21
MEGA_SIDE_MAX = 1.75   # two launches one after the other take about 2x
# M1's device time at these budgets (a 3-iteration 4096^2 task); the probe
# of a chunk's parts at each, repetitions a part
MEGA_TIME_BUDGETS = (1, 8)
MEGA_PROBE_REPS = 256
# a flag write into a running M1 launch: a 4096^2 task of this many
# iterations at budget 1 (never reached), the flag written once the launch
# has published this many chunks
MEGA_LAG_ITERS = 200
MEGA_LAG_AT = 200
MEGA_LAG_TRIALS = 5
MEGA_AB_RUNS = 4       # main-path megakernel runs a process of --ab-mega
REPLACES_MEGA = "src/repro/core/preemption.py:174"
# [cluster]: the pipelined hop lands at this chunk boundary of its task, the
# failure at this one of the task it kills; the migrate arm retries
# ``migrate(prefer="running")`` this long for its one forced migration
CLUSTER_HOP_AT = 3
CLUSTER_FAIL_AT = 4
CLUSTER_MIGRATE_WAIT_S = 5.0
LIBRARIES = ("blur", "preempt_flag", "flash_attention", "decode_attention",
             "rglru_scan", "rwkv6", "seq_lm", "attn_lm")
# [decode]: the surrogate LM at its published scale, the reference's serve
# decode defaults (src/repro/launch/serve.py:514-517: whisper-tiny's d_model
# and vocabulary), and the main path's traffic
SURROGATE = {"d_model": 384, "vocab": 51865}
DECODE_MAIN = {"n_sequences": 64, "prompt_len": 128, "max_new": 64,
               "slots": 32, "round_tokens": 8}
DECODE_PREEMPT_EVERY = 3
DECODE_AB = ("pipelined", "megakernel", "megakernel", "pipelined")
SEQ_BUDGETS = (1, 2, 4)
SEQ_RANDOM_TASKS = 3        # random-boundary tasks a kernel at the main shapes
SEQ_LAG_STEPS = 200_000     # M2/M3 steps of the flag-lag launch (never reached)
SEQ_LAG_AT = 2000           # its progress when the host writes the flag
SEQ_LAG_TRIALS = 5
# M2/M3's times: budget 1 (the main path with probes, a step a chunk) and 2
# (the main path without them); --ab-seq times both in two trees
SEQ_TIME_BUDGETS = (1, 2)
SEQ_AB_DECODE_RUNS = 2      # timed serve_decode runs a process of --ab-seq

# the attention LM at Qwen3-8B's attention widths (src/repro/configs/qwen3_8b.py)
SERVING = {"lm": "attention", "d_model": 4096, "vocab_size": 151936,
           "attn_heads": 32, "attn_kv_heads": 8, "attn_head_dim": 128,
           "kv_block_size": 16, "max_ctx": 128, "weights_seed": 7,
           "max_slots": 8, "round_tokens": 8, "prefill_batch": 4,
           "prefill_regions": (0,), "decode_regions": (1,)}
N_SEQS = 16
SERVE_CHUNK_BUDGET = 2     # 4 chunks per prefill task and per decode round
PREEMPT_EVERY = 3          # every 3rd decode round, at its 2nd chunk
F32_TOL, BF16_TOL = 2e-5, 2e-2
# [serve, mega]: M4/M5 against their plain versions at these budgets, the
# flag at every boundary of one task each, then random boundaries of
# ATTN_RANDOM_TASKS tasks at budget 1; the flag-lag launch of M5 runs
# ATTN_LAG_STEPS steps (never reached) and the host writes the flag once
# it has published ATTN_LAG_AT chunks.  At budget 8 M4's one chunk of 512
# rows takes 4 passes of its projections.  M4 also runs, at every boundary
# at the main path's budget, prompts of ATTN_EMIT_LENS: rows that all emit
# in its first chunk, and rows that emit in each of its 4 chunks
ATTN_BUDGETS = (1, 2, 4, 8)
ATTN_EMIT_LENS = ((3, 9, 20, 32), (10, 40, 70, 100))
ATTN_RANDOM_TASKS = 3
ATTN_PROMPT_LENS = (8, 96)
ATTN_LAG_STEPS = 400
ATTN_LAG_AT = 10
ATTN_LAG_TRIALS = 3
FLASH_OFFSETS = (0, 64, 112)
# B2's edges beyond the serving shape, (B, H, KV, T, S, hd, q_offset,
# window): groups 1, 8 and 32 (16 heads a block), hd 16 and 120, a window,
# a ragged T against a ragged S, hd 8, hd 30 (element staging), two and
# three passes of 128 keys (the first skipped by a window); then the
# serving layout shifted by one element (nothing 16-byte aligned) and a
# window of 0 (every row fully masked, exactly 0)
FLASH_EDGES = ((4, 32, 32, 16, 128, 128, 112, None),
               (4, 32, 4, 16, 128, 128, 112, None),
               (1, 32, 1, 16, 128, 128, 48, None),
               (4, 32, 8, 16, 128, 16, 64, None),
               (4, 32, 8, 16, 128, 120, 112, None),
               (4, 32, 8, 16, 128, 128, 96, 40),
               (2, 6, 2, 40, 70, 64, 30, None),
               (2, 8, 2, 16, 64, 8, 48, 9),
               (2, 4, 2, 16, 48, 30, 32, None),
               (1, 4, 4, 16, 260, 128, 240, None),
               (2, 8, 2, 16, 300, 64, 270, 100))
# without the causal mask: three passes with keys past every row, and a
# window that skips the first pass
FLASH_NON_CAUSAL = ((4, 32, 8, 16, 300, 128, 0, None),
                    (2, 8, 2, 16, 384, 64, 300, 150))
# B3's edges beyond the serving shape, (H, KV, hd): groups 1 and 8, hd 64
DECODE_EDGES = ((32, 32, 128), (32, 4, 128), (32, 8, 64), (32, 4, 64))
REPLACES_ATTN = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:24",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:22"}
# the recurrent models, served at full width (src/repro/configs/)
RECURRENT_ARCHS = ("rwkv6-1.6b", "recurrentgemma-9b")
TRAIN = {"arch": "rwkv6-1.6b", "batch": 8, "seq": 128, "steps": 8}
TRAIN_100M = {"steps": 20, "ckpt_every": 10}
SERVE_LM = {"batch": 4, "prompt_len": 128, "gen": 32, "seed": 0}
# the prefill logits of the kernel path against the plain replay: B5 sums
# each readout in another order than the plain einsum, and over 24 layers
# at d_model 2048 that moved them by 1.4e-4 in a first chip run (the
# reduced models on the CPU agree with the reference to 4e-6)
SCAN_TOL, RWKV_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-3
# [encdec]: whisper-tiny at full width and depth (4 + 4 layers, 1500 frames
# of Whisper's 30 s window), and llava-next-34b at full width, 8 of its 60
# layers (all 60 in f32 would take ~138 GB)
WHISPER_SERVE = {"batch": 4, "prompt_len": 4, "gen": 64, "seed": 0}
WHISPER_TRAIN = {"batch": 8, "seq": 64, "steps": 8, "q_chunk": 64}
LLAVA = {"layers": 8, "batch": 2, "prompt_len": 64, "gen": 16, "seed": 0}
GAP_TOL = 1e-4       # the CPU's top-two gap where a greedy stream differs
TEACHER_TOL = 2e-2   # decode against forward: tests/test_arch_smoke.py:127
# the reference's sweep shapes (tests/test_kernels.py:60, :73), then the
# edges of the kernels' designs: B4's segments and time tiles (T 2, 17,
# 129, 2048) and channel stripes (L 100: a channel a thread; 4096: a float4);
# B5's 16-step chunks (T 15, 16, 17, 33, 300) and 16-column blocks (hd 8,
# 16, 40, 64)
SCAN_SHAPES = ((2, 64, 200), (1, 128, 128), (3, 33, 100), (2, 2, 100),
               (2, 17, 100), (2, 129, 4096), (1, 2048, 100),
               (2, 2048, 4096))
RWKV_SHAPES = ((2, 48, 3, 16), (1, 64, 2, 32), (2, 17, 4, 8), (2, 15, 4, 64),
               (2, 16, 4, 64), (2, 17, 4, 64), (2, 33, 3, 64),
               (1, 300, 2, 64), (2, 33, 2, 8), (2, 33, 2, 16),
               (2, 33, 2, 40))
L2_BYTES = 50e6             # H100 SXM L2; the cold timings rotate past it
RECURRENCES = {  # name -> (kernel source, TPU kernel, counter key)
    "rglru_scan": ("src/repro_torch/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:33", "rglru"),
    "rwkv6": ("src/repro_torch/csrc/rwkv6.cu",
              "src/repro/kernels/rwkv6/kernel.py:38", "rwkv6")}


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 3, attempts: int = 3,
              launches: Optional[int] = None) -> float:
    """Device time of one ``fn()`` in ms: every kernel's duration in the
    window, from ``torch.profiler`` (CUDA activity only), averaged over
    ``reps`` calls after a warm-up.  A window in which the profiler saw no
    device activity, or (given ``launches``, the kernels one call runs)
    fewer kernels than the calls ran, is profiled again, up to
    ``attempts`` times; 0.0 if no window was whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if getattr(e, "self_device_time_total", 0.0) > 0]
        total_us = sum(e.self_device_time_total for e in seen)
        if total_us > 0 and (launches is None
                             or sum(e.count for e in seen) >= launches * reps):
            return total_us / 1e3 / reps
    return 0.0


def queued_ms(fn, reps: int = 20) -> float:
    """Mean ms of ``fn()`` by CUDA events around ``reps`` calls queued
    behind a spin kernel: the host enqueues them while the card spins, so
    the events time the card's work back to back, not the host's launch
    overhead.  For the profiler's missed windows."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)  # cycles, ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(kind: str, got, want) -> float:
    err = float((got - want).abs().max())
    if kind == "median":
        if not bool((got == want).all()):
            raise AssertionError(f"median not bitwise equal: max err {err}")
    elif err > GAUSS_TOL:
        raise AssertionError(f"gaussian max err {err} > {GAUSS_TOL}")
    return err


def serve(imgs, slowdown_s: float, tracer=None, metrics=None,
          window: Optional[str] = None, engine: str = "pipelined"):
    """The main path: ``repro_torch.Client(n_regions=2, engine=engine)`` on
    cuda:0, two priority-4 MedianBlur tasks, then — once both have retired
    a chunk — a priority-0 GaussianBlur.  Each background task's worker
    waits at its first chunk boundary until both have got there, the
    urgent task is submitted, and the scheduler has asked a region to
    yield, so the victim honours the request with most of its chunks still
    to run (left to the host's timing, a late arrival can find the victim
    at its last chunk, and the request goes stale).  In megakernel mode a
    launch runs its chunks without the host, so the wait is placed just
    before the launches instead, and the request is read back from the
    flag on the card; the victim's launch then exits on the flag at its
    first chunk boundary.
    The launch and row-block counters are zeroed just before and read just
    after.  With ``metrics``, a ``TelemetryMonitor`` attached to the
    scheduler samples every ``MONITOR_INTERVAL_S`` while the tasks run.
    With ``window``, the span from the first submission to the last result
    is a ``torch.profiler`` range of that name.  Returns (background tasks,
    urgent task, report, wall seconds, ({body: row blocks}, {body: B1
    launches}, {body: M1 launches}))."""
    import contextlib

    from torch.profiler import record_function

    import repro_torch
    from repro_torch.obs import TelemetryMonitor

    tasks = [_blur_task("MedianBlur", imgs[i], BG_ITERS, 4) for i in (0, 1)]
    urgent = _blur_task("GaussianBlur", imgs[2], URGENT_ITERS, 0)
    started, both_started = set(), threading.Event()
    release = threading.Event()  # the background tasks may go on
    lock = threading.Lock()

    def arrive(t):
        with lock:
            started.add(t.tid)
            if all(b.tid in started for b in tasks):
                both_started.set()

    def on_chunk(region, t):
        arrive(t)
        if (engine != "megakernel" and not release.is_set()
                and any(t is b for b in tasks)):
            release.wait(TIMEOUT_S)

    def on_launch(region, t):
        if release.is_set() or all(t is not b for b in tasks):
            return
        arrive(t)
        release.wait(TIMEOUT_S)

    client = repro_torch.Client(n_regions=2, tracer=tracer, metrics=metrics,
                                engine=engine)
    monitor = None
    try:
        for r in client.shell.regions:
            r.slowdown_s = slowdown_s
            r.on_chunk = on_chunk
            r.on_launch = on_launch
        if metrics is not None:
            monitor = TelemetryMonitor(
                metrics, interval_s=MONITOR_INTERVAL_S).attach(
                    scheduler=client.scheduler)
            monitor.start()
        _reset_counts()
        with (record_function(window) if window is not None
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            handles = [client.submit(t) for t in tasks]
            if not both_started.wait(TIMEOUT_S):
                raise AssertionError("background tasks never retired a "
                                     "chunk")
            handles.append(client.submit(urgent))
            if engine == "megakernel":
                asked = _wait(lambda: any(r.flag.read()
                                          for r in client.shell.regions))
            else:
                asked = _wait(lambda: any(r.preempt_requested
                                          for r in client.shell.regions))
            release.set()
            if not asked:
                raise AssertionError("the urgent task asked no region to "
                                     "yield")
            for h in handles:
                h.result(timeout=TIMEOUT_S)
            wall_s = time.perf_counter() - t0
        counts = _counts()
        if monitor is not None:
            monitor.stop()
            monitor.sample()
        rep = client.drain(TIMEOUT_S)
    finally:
        release.set()
        if monitor is not None:
            monitor.stop()
        client.shutdown()
    return tasks, urgent, rep, wall_s, counts


def _wait(cond, timeout: float = TIMEOUT_S) -> bool:
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            return False
        time.sleep(1e-4)
    return True


def log_serve(tag: str, tasks, urgent, rep, wall_s: float, slowdown_s: float):
    chunk_ms = sum(t.run_s for t in (*tasks, urgent)) / rep["chunks"] * 1e3
    log(f"[{tag}] {rep['n_done']} tasks in {wall_s:.3f} s, preemptions "
        f"{rep['preemptions']}, chunks {rep['chunks']} (mean {chunk_ms:.3f} "
        f"ms host per chunk incl. {slowdown_s * 1e3:g} ms slowdown), "
        f"host_spills_avoided {rep['host_spills_avoided']}, reconfigs "
        f"{rep['reconfigs']}, kernel_mode "
        f"{[r['kernel_mode'] for r in rep['reconfig']['regions'].values()]}")
    log(f"[{tag}] urgent service {urgent.service_time * 1e3:.3f} ms, "
        f"turnaround {urgent.turnaround * 1e3:.3f} ms; background "
        f"turnarounds {[round(t.turnaround * 1e3, 3) for t in tasks]} ms; "
        f"chunks_pipelined {rep['chunks_pipelined']}, chunks_discarded "
        f"{rep['chunks_discarded']}, dispatch_stall_s "
        f"{rep['dispatch_stall_s']:.6f}")


def _blur_task(kernel: str, img, iters: int, priority: int,
               arrival_time: float = 0.0):
    import numpy as np

    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.task import Task

    return Task(kernel=kernel, priority=priority, arrival_time=arrival_time,
                args=get_kernel(kernel).bundle(img, np.zeros_like(img),
                                               H=SIZE, W=SIZE, iters=iters))


def _plain_image(img, iters: int, kernel: str, dev):
    """The plain PyTorch version's image on the card, back on the host."""
    import torch

    from repro_torch.kernels.blur import ref as R

    kind = "median" if kernel == "MedianBlur" else "gaussian"
    return R.iterated_blur_ref(torch.tensor(img, device=dev), iters,
                               kind).cpu()


def _check_result(task, img, iters: int, dev) -> float:
    import torch

    from repro_torch.kernels.blur.tasks import result_image

    kind = "median" if task.kernel == "MedianBlur" else "gaussian"
    return check(kind, torch.tensor(result_image(task, iters)),
                 _plain_image(img, iters, task.kernel, dev))


def _counts():
    from repro_torch.kernels.blur import kernel as K

    return tuple({k: c[k] for k in ("median", "gaussian")}
                 for c in (K.ROW_BLOCKS, K.LAUNCHES, K.MEGA_LAUNCHES))


def _reset_counts():
    from repro_torch.kernels.blur import kernel as K

    K.LAUNCHES.reset()
    K.ROW_BLOCKS.reset()
    K.MEGA_LAUNCHES.reset()


def _want_blocks(specs) -> dict:
    """Row blocks a set of (kernel, iterations) runs through the kernel:
    every row block of every pass exactly once."""
    from repro_torch.kernels.blur.tasks import ROW_BLOCK

    want = {"median": 0, "gaussian": 0}
    for kernel, iters in specs:
        kind = "median" if kernel == "MedianBlur" else "gaussian"
        want[kind] += iters * (SIZE // ROW_BLOCK)
    return want


def _require_counts(tag: str, want: dict):
    blocks, launches, _ = _counts()
    log(f"[{tag}] row blocks {blocks} (expected exactly {want}); launches "
        f"{launches}")
    if blocks != want:
        raise AssertionError(f"[{tag}] row-block count {blocks} != {want}")
    for kind, n in want.items():
        if n and launches[kind] < 1:
            raise AssertionError(f"[{tag}] the {kind} kernel never launched")


def _unpreempted(task, dev):
    """The task's (ping, pong) from an unpreempted run of the port's chunk
    loop on the card (``run_to_completion`` with its kernel's default
    budget), as host arrays."""
    import torch

    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import run_to_completion

    kd = get_kernel(task.kernel)
    bufs, ints, floats = task.args.padded()
    _, state, _ = run_to_completion(
        kd.fn, ContextRecord.fresh(), tuple(torch.tensor(b, device=dev)
                                            for b in bufs),
        ints, floats, budget=kd.default_budget)
    return tuple(b.cpu().numpy() for b in state[:2])


def pool_phase(rng, dev):
    """5a. ``Client(backend=Scheduler(Shell(n_regions=1), pool=RegionPool(
    shell, min_regions=1, max_regions=2)))`` on cuda:0.  The first
    priority-4 MedianBlur runs alone; at its first chunk boundary (its
    region's ``on_chunk``) the rest of the priority-4 burst is submitted,
    ``request_grow()`` grows the pool to 2 regions (a second CUDA stream),
    and ``request_shrink(rid)`` drains the region running it: the task is
    checkpoint-preempted, requeued and finished on the survivor, and its
    (ping, pong) must equal an unpreempted run of the port bitwise.  Then a
    priority-0 GaussianBlur arrives.  Row blocks must be exactly
    sum(iters x 128)."""
    import numpy as np

    import repro_torch
    from repro_torch.core.pool import RegionPool
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.core.shell import Shell
    from repro_torch.kernels.blur.tasks import make_image

    imgs = [make_image(rng, SIZE) for _ in POOL_BURST]
    tasks = [_blur_task(k, im, it, p)
             for (k, it, p), im in zip(POOL_BURST, imgs)]
    first, burst, urgent = tasks[0], tasks[1:-1], tasks[-1]
    shell = Shell(n_regions=1)
    pool = RegionPool(shell, min_regions=1, max_regions=2)
    client = repro_torch.Client(backend=Scheduler(shell, pool=pool))
    handles, drained, errors, grown_at = [], [], [], []

    def on_chunk(region, task):
        if task is not first or drained:
            return
        drained.append(region.rid)
        handles.extend(client.submit(t) for t in burst)
        pool.request_grow()
        deadline = time.perf_counter() + TIMEOUT_S
        while len(shell.regions) < 2 and time.perf_counter() < deadline:
            time.sleep(0.001)
        grown_at.append(len(shell.regions))
        pool.request_shrink(region.rid)
        if not region._preempt.wait(TIMEOUT_S):
            errors.append("the drain never preempted the running task")
        handles.append(client.submit(urgent))

    try:
        shell.regions[0].on_chunk = on_chunk
        _reset_counts()
        t0 = time.perf_counter()
        client.submit(first).result(timeout=TIMEOUT_S)
        for h in handles:  # submitted by the hook at the drain
            h.result(timeout=TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        _require_counts("pool", _want_blocks((k, it)
                                              for k, it, _ in POOL_BURST))
        deadline = time.perf_counter() + TIMEOUT_S
        while len(shell.regions) > 1 and time.perf_counter() < deadline:
            time.sleep(0.001)
        rep = client.drain(TIMEOUT_S)
    finally:
        client.shutdown()
        shell.shutdown()
    if errors:
        raise AssertionError(f"[pool] {errors}")
    pstats = rep["pool"]
    log(f"[pool] {rep['n_done']} tasks in {wall_s:.3f} s; grows "
        f"{pstats['grows']}, shrinks {pstats['shrinks']}, resize_events "
        f"{pstats['resize_events']}, region_seconds "
        f"{pstats['region_seconds']:.6f}, utilization "
        f"{pstats['utilization']:.6f}; regions at the grow {grown_at}, "
        f"preemptions {rep['preemptions']}")
    if grown_at != [2] or (pstats["grows"], pstats["shrinks"]) != (1, 1):
        raise AssertionError(f"[pool] expected one grow to 2 regions and one "
                             f"shrink: {grown_at}, {pstats}")
    if len(shell.regions) != 1 or rep["n_done"] != len(tasks):
        raise AssertionError(f"[pool] {len(shell.regions)} regions left, "
                             f"{rep['n_done']} tasks done")
    if first.n_preemptions < 1 or len(set(first.region_history)) != 2:
        raise AssertionError(f"[pool] the drained task was not resumed on "
                             f"the survivor: {first.region_history}")
    # the drained task against an unpreempted run of the port on the card
    for i, (name, want) in enumerate(zip(("ping", "pong"),
                                         _unpreempted(first, dev))):
        if not np.array_equal(first.result[i], want):
            raise AssertionError(f"[pool] the drained task's {name} differs "
                                 f"from the unpreempted run")
    log(f"[pool] drained task #{first.tid}: preempted "
        f"{first.n_preemptions}x on regions {first.region_history}, (ping, "
        f"pong) bitwise equal to the unpreempted run")
    for (kernel, iters, _), t, im in zip(POOL_BURST, tasks, imgs):
        err = _check_result(t, im, iters, dev)
        log(f"[pool] task #{t.tid} {kernel} x{iters} (priority "
            f"{t.priority}): preempted {t.n_preemptions}x on regions "
            f"{t.region_history}, max_abs_err {err:.3e}")


def controller_phase(rng, dev):
    """5b. The deprecated ``Controller`` (``tests/test_system.py::
    test_controller_end_to_end``) on cuda:0: two launches, ``run()``, then
    ``wait()``; every result equals the plain version."""
    import warnings

    from repro_torch.controller import Controller
    from repro_torch.controller.hittile import HitTile
    from repro_torch.core.shell import Shell
    from repro_torch.kernels.blur.tasks import make_image

    img = make_image(rng, SIZE)
    shell = Shell(n_regions=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ctrl = Controller(shell)
    try:
        _reset_counts()
        t1 = ctrl.launch("MedianBlur", (HitTile.of(img),
                                        HitTile.zeros(img.shape)),
                         priority=1, H=SIZE, W=SIZE, iters=2)
        t2 = ctrl.launch("GaussianBlur", (HitTile.of(img),
                                          HitTile.zeros(img.shape)),
                         priority=3, H=SIZE, W=SIZE, iters=1)
        rep = ctrl.run()
        for t in (t1, t2):
            ctrl.wait(t, timeout=TIMEOUT_S)
        _require_counts("controller", _want_blocks((("MedianBlur", 2),
                                                    ("GaussianBlur", 1))))
    finally:
        ctrl.shutdown()
    if rep["n_done"] != 2:
        raise AssertionError(f"[controller] {rep['n_done']} of 2 tasks done")
    for t, iters in ((t1, 2), (t2, 1)):
        err = _check_result(t, img, iters, dev)
        log(f"[controller] task #{t.tid} {t.kernel} x{iters}: "
            f"{t.status.value} on regions {t.region_history}, max_abs_err "
            f"{err:.3e}")


def _harness_stream(rng_seed: int, dev):
    """The reference harness's mix (``HARNESS_MIX``, ``OVERHEAD_TASKS``
    tasks at 4096^2, arrivals uniform over ``OVERHEAD_SPAN_S``) from
    ``rng_seed``: the tasks, their iterations and each one's plain image
    made on the card."""
    import numpy as np

    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.task import generate_random_tasks
    from repro_torch.kernels.blur.tasks import make_image

    def arg_factory(r, name):
        kernel, iters = HARNESS_MIX[name]
        img = make_image(r, SIZE)
        return get_kernel(kernel).bundle(img, np.zeros_like(img), H=SIZE,
                                         W=SIZE, iters=iters)

    stream = generate_random_tasks(np.random.default_rng(rng_seed),
                                   list(HARNESS_MIX), OVERHEAD_TASKS,
                                   OVERHEAD_SPAN_S, arg_factory)
    for t in stream:
        t.kernel = HARNESS_MIX[t.kernel][0]
    iters = [int(t.args.ints[2]) for t in stream]
    want = [_plain_image(np.asarray(t.args.bufs[0]), it, t.kernel,
                         dev).numpy() for t, it in zip(stream, iters)]
    return stream, iters, want


def _check_stream(tag: str, tasks, iters, want):
    """Every task's image against its plain version's."""
    import torch

    from repro_torch.kernels.blur.tasks import result_image

    for t, it, w in zip(tasks, iters, want):
        kind = "median" if t.kernel == "MedianBlur" else "gaussian"
        try:
            check(kind, torch.from_numpy(result_image(t, it)),
                  torch.from_numpy(w))
        except AssertionError as e:
            raise AssertionError(f"[{tag}] task #{t.tid}: {e}") from None


def overhead_phase(rng_seed: int, dev) -> dict:
    """5c. The paper's metric (i) and its §6.3 headline on the card: one
    seeded stream (the reference harness's mix, ``HARNESS_MIX``, seed 15,
    12 tasks at 4096^2, arrivals uniform over ``OVERHEAD_SPAN_S``) through
    ``Scheduler.run`` at 1 and at 2 regions, preemption off and on, the
    arms alternated off, on, on, off at each region count in this one
    process, twice (``OVERHEAD_ROUNDS``), both bitstreams prewarmed.
    Every arm's images must equal the plain version's.  Prints each arm's
    tasks/s, preemptions and urgent (priority <= 1) service time p50/p99,
    then the overhead ``1 - tput(on) / tput(off)`` over all arms and by
    round, beside the paper's FPGA figures."""
    import numpy as np

    from repro_torch.core.scheduler import Scheduler, SchedulerConfig
    from repro_torch.core.shell import Shell
    from repro_torch.core.task import Task

    t0 = time.perf_counter()
    stream, iters, want = _harness_stream(rng_seed, dev)
    log(f"[overhead] stream: {OVERHEAD_TASKS} tasks (seed {rng_seed}), "
        f"kernels {[(t.kernel, it) for t, it in zip(stream, iters)]}, "
        f"priorities {[t.priority for t in stream]}, arrivals over "
        f"{OVERHEAD_SPAN_S} s (mean spacing "
        f"{OVERHEAD_SPAN_S / OVERHEAD_TASKS * 1e3:.1f} ms); made with the "
        f"plain images in {time.perf_counter() - t0:.3f} s")

    def arm(n_regions: int, preemption: bool) -> dict:
        shell = Shell(n_regions=n_regions)
        try:
            for kname in ("MedianBlur", "GaussianBlur"):
                shell.engine.prewarm(kname, stream[0].args,
                                     shell.regions[0].geometry)
            sched = Scheduler(shell, SchedulerConfig(preemption=preemption))
            tasks = [Task(kernel=t.kernel, args=t.args, priority=t.priority,
                          arrival_time=t.arrival_time) for t in stream]
            rep = sched.run(tasks, quiet=True)
        finally:
            shell.shutdown()
        _check_stream("overhead", tasks, iters, want)
        urgent = sorted(t.service_time for t in tasks if t.priority <= 1)
        # the card's time a task: the serving window (first service to
        # last completion) over the tasks; a task's upload and result
        # copy run on its region's worker inside that window
        span = (max(t.t_done for t in tasks)
                - min(t.t_first_served for t in tasks))
        return {"tput": rep["throughput_tps"], "wall_s": rep["wall_s"],
                "preemptions": rep["preemptions"], "n_done": rep["n_done"],
                "urgent_p50_ms": sched._percentile(urgent, 0.50) * 1e3,
                "urgent_p99_ms": sched._percentile(urgent, 0.99) * 1e3,
                "n_urgent": len(urgent),
                "task_ms": span / len(tasks) * 1e3}

    _reset_counts()
    out = {}
    for n_regions in (1, 2):
        runs = {False: [], True: []}
        rounds = []  # each round's own overhead: the spread is the noise
        for rnd in range(OVERHEAD_ROUNDS):
            this = {False: [], True: []}
            for k, preemption in enumerate((False, True, True, False)):
                r = arm(n_regions, preemption)
                this[preemption].append(r["tput"])
                runs[preemption].append(r)
                if r["n_done"] != OVERHEAD_TASKS:
                    raise AssertionError(f"[overhead] {r['n_done']} of "
                                         f"{OVERHEAD_TASKS} tasks done")
                if not preemption and r["preemptions"]:
                    raise AssertionError("[overhead] preempted with "
                                         "preemption off")
                log(f"[overhead] {n_regions} region(s), round {rnd + 1}, "
                    f"preemption {'on' if preemption else 'off'} (arm "
                    f"{k + 1} of 4): {r['tput']:.4f} tasks/s over "
                    f"{r['wall_s']:.3f} s, preemptions {r['preemptions']}, "
                    f"urgent (priority <= 1, n={r['n_urgent']}) service p50 "
                    f"{r['urgent_p50_ms']:.3f} ms, p99 "
                    f"{r['urgent_p99_ms']:.3f} ms; {r['task_ms']:.3f} ms of "
                    f"the serving window a task")
                if n_regions == 1 and rnd == 0 and k == 0:
                    spacing = OVERHEAD_SPAN_S / OVERHEAD_TASKS * 1e3
                    busy = spacing < r["task_ms"]
                    log(f"[overhead] one task's service on the card (first "
                        f"arm: the one region's serving window over the "
                        f"tasks, copies included) {r['task_ms']:.3f} ms "
                        f"against a mean arrival spacing of {spacing:.1f} "
                        f"ms: the card "
                        f"{'stays busy' if busy else 'idles between tasks'}")
            rounds.append((1.0 - np.mean(this[True]) / np.mean(this[False]))
                          * 100.0)
        tput = {p: float(np.mean([r["tput"] for r in runs[p]]))
                for p in runs}
        pct = (1.0 - tput[True] / tput[False]) * 100.0
        out[n_regions] = {"overhead_pct": pct, "tput_off": tput[False],
                          "tput_on": tput[True],
                          "rounds_pct": [float(x) for x in rounds],
                          "preemptions_on": [r["preemptions"]
                                             for r in runs[True]],
                          "runs": {str(p): runs[p] for p in runs}}
        log(f"[overhead] {n_regions} region(s): preemption overhead "
            f"{pct:.3f} % (1 - {tput[True]:.4f} / {tput[False]:.4f} tasks/s, "
            f"mean of {2 * OVERHEAD_ROUNDS} arms each; by round "
            f"{', '.join(f'{x:.3f}' for x in rounds)} %); the paper's FPGA "
            f"figure {PAPER_OVERHEAD_PCT[n_regions]} %")
    _require_counts("overhead", {
        k: 8 * OVERHEAD_ROUNDS * v for k, v in _want_blocks(
            (t.kernel, it) for t, it in zip(stream, iters)).items()})
    return out


def _merged(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _busy_share(prof_json: str, window: str) -> dict:
    """The card's busy share in a ``torch.profiler`` Chrome trace: the
    union of its kernel, copy and memset intervals inside the host range
    annotated ``window``, over that range; and how long host-to-device
    and device-to-host copies ran at the same time."""
    with open(prof_json) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events
                if e.get("name") == window
                and e.get("cat") == "user_annotation")
    lo, hi = span["ts"], span["ts"] + span["dur"]
    found = {"kernel": [], "gpu_memcpy": [], "gpu_memset": []}
    for e in events:
        if e.get("cat") in found and "dur" in e:
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if b > a:
                found[e["cat"]].append((a, b))
    busy = sum(b - a for a, b in _merged(x for xs in found.values()
                                         for x in xs))
    ways = {d: _merged((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                       for e in events
                       if e.get("cat") == "gpu_memcpy" and "dur" in e
                       and d in e.get("name", ""))
            for d in ("HtoD", "DtoH")}
    overlap = sum(max(0.0, min(b, d) - max(a, c))
                  for a, b in ways["HtoD"] for c, d in ways["DtoH"])
    return {"window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (hi - lo),
            "copy_overlap_ms": overlap / 1e3,
            **{f"{k}_n": len(v) for k, v in found.items()},
            **{f"{k}_ms": sum(b - a for a, b in v) / 1e3
               for k, v in found.items()}}


def _emit_cost_us(n_threads: int) -> float:
    """Wall microseconds per ``Tracer.emit`` with ``n_threads`` threads
    emitting into one tracer at once (all threads' emits together: the
    lock's and the interpreter's contention)."""
    from repro_torch.obs import Tracer

    tr = Tracer()
    go = threading.Barrier(n_threads + 1)

    def emit():
        go.wait()
        for i in range(EMITS):
            tr.emit("chunk", ("region", 0), tid=i, t=0.0, dur=1e-3)

    threads = [threading.Thread(target=emit) for _ in range(n_threads)]
    for t in threads:
        t.start()
    go.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return (time.perf_counter() - t0) / (n_threads * EMITS) * 1e6


def trace_phase(imgs, dev) -> dict:
    """5d. The main path's workload (4) without the injected slowdown under
    the flight recorder and live telemetry, checked; then traced against
    untraced runs, alternated, the tracer's emit cost, and the same
    workload under ``torch.profiler`` for the card's busy share.  Returns
    the numbers it printed."""
    import statistics
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import MetricsRegistry, Tracer, export_chrome_trace

    tracer, reg = Tracer(), MetricsRegistry()
    tasks, urgent, rep, wall_s, (blocks, launches, _) = serve(
        imgs, 0.0, tracer=tracer, metrics=reg)
    want = _want_blocks([("MedianBlur", BG_ITERS), ("MedianBlur", BG_ITERS),
                         ("GaussianBlur", URGENT_ITERS)])
    log(f"[trace] row blocks {blocks} (expected exactly {want}); launches "
        f"{launches}")
    if blocks != want or min(launches.values()) < 1:
        raise AssertionError(f"[trace] row blocks {blocks} != {want} or a "
                             f"kernel never launched ({launches})")
    for t, im, iters in ((tasks[0], imgs[0], BG_ITERS),
                         (tasks[1], imgs[1], BG_ITERS),
                         (urgent, imgs[2], URGENT_ITERS)):
        _check_result(t, im, iters, dev)
    evs = tracer.events()
    kinds = {}
    for e in evs:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    t = rep["trace"]
    preempts = sum(inst.value for kind, name, _l, inst in reg.series()
                   if name == "preemptions_total")
    log(f"[trace] {wall_s * 1e3:.3f} ms wall; {tracer.n_emitted} events "
        f"({tracer.n_emitted / rep['chunks']:.3f} a chunk over "
        f"{rep['chunks']} chunks), dropped {tracer.dropped}; kinds {kinds}")
    log(f"[trace] per_task n_tasks {t['per_task']['n_tasks']}; "
        f"preempt_response {t['preempt_response']}; registry "
        f"preemptions_total {preempts:g}, report preemptions "
        f"{rep['preemptions']}; telemetry samples "
        f"{rep['telemetry']['samples']}, series "
        f"{rep['telemetry']['n_series']}, alerts {rep['telemetry']['alerts']}")
    missing = [k for k in TRACE_KINDS if k not in kinds]
    if (missing or kinds["chunk"] != rep["chunks"] or tracer.dropped
            or t["per_task"]["n_tasks"] != 3
            or t["preempt_response"]["n"] < 1
            or preempts != rep["preemptions"]):
        raise AssertionError(
            f"[trace] missing kinds {missing}, chunk events "
            f"{kinds.get('chunk')} against {rep['chunks']} chunks, dropped "
            f"{tracer.dropped}, tasks {t['per_task']['n_tasks']}, preempt "
            f"responses {t['preempt_response']['n']}, preemptions_total "
            f"{preempts} against {rep['preemptions']}")
    window_s = t["window_s"]
    for rid, r in sorted(t["regions"].items()):
        log(f"[trace] region {rid}: occupancy {r['occupancy']:.4f} (busy "
            f"{r['busy_s'] * 1e3:.3f} ms of the {window_s * 1e3:.3f} ms "
            f"window), idle gaps {r['idle_gaps']}")
    phases = {p: round(v["mean"], 6)
              for p, v in t["per_task"]["phases"].items()}
    log(f"[trace] phases (per task, mean s): {phases}; icap {t['icap']}, "
        f"compile {t['compile']}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        export_chrome_trace(tracer, path=str(path))
        out = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "trace_report.py"),
             str(path)], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise AssertionError(f"[trace] tools/trace_report.py exit "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    log(f"[trace] tools/trace_report.py: exit 0, "
        f"{len(out.stdout.splitlines())} lines; "
        + " | ".join(ln.strip() for ln in out.stdout.splitlines()
                     if "preempt" in ln or "window" in ln))

    # the tracer's enabled cost, before anything else has run in between
    arms = {False: [], True: []}
    for _ in range(TRACE_ROUNDS):
        for traced in (False, True):
            tr, rg = (Tracer(), MetricsRegistry()) if traced else (None, None)
            a_tasks, a_urgent, a_rep, a_wall, _ = serve(imgs, 0.0, tracer=tr,
                                                        metrics=rg)
            host_ms = (sum(x.run_s for x in (*a_tasks, a_urgent))
                       / a_rep["chunks"] * 1e3)
            arms[traced].append((a_wall * 1e3, host_ms,
                                 a_urgent.service_time * 1e3))
            log(f"[trace] {'traced' if traced else 'untraced'} run: wall "
                f"{a_wall * 1e3:.3f} ms, {host_ms:.4f} ms host per chunk "
                f"({a_rep['chunks']} chunks), urgent service "
                f"{a_urgent.service_time * 1e3:.3f} ms, preemptions "
                f"{a_rep['preemptions']}")
    med = {k: [statistics.median(x[i] for x in v) for i in range(3)]
           for k, v in arms.items()}
    log(f"[trace] medians of {TRACE_ROUNDS}, untraced / traced: wall "
        f"{med[False][0]:.3f} / {med[True][0]:.3f} ms, host per chunk "
        f"{med[False][1]:.4f} / {med[True][1]:.4f} ms, urgent service "
        f"{med[False][2]:.3f} / {med[True][2]:.3f} ms")

    emit_us = {n: _emit_cost_us(n) for n in (1, 4)}
    log(f"[trace] Tracer.emit: {emit_us[1]:.4f} us per emit on one thread, "
        f"{emit_us[4]:.4f} us of wall per emit with 4 threads emitting at "
        f"once ({EMITS} emits each)")

    # the card's busy share over the same (untraced) workload
    with tempfile.TemporaryDirectory() as tmp:
        prof_json = str(Path(tmp) / "profile.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, p_rep, p_wall, _ = serve(imgs, 0.0, window="trace_window")
        prof.export_chrome_trace(prof_json)
        share = _busy_share(prof_json, "trace_window")
    log(f"[trace] torch.profiler over the same workload, untraced, first "
        f"submission to last result ({p_wall * 1e3:.3f} ms wall, "
        f"{p_rep['chunks']} chunks): card busy "
        f"{share['busy_ms']:.3f} ms of the {share['window_ms']:.3f} ms "
        f"window, busy share {share['busy_share']:.4f}; kernels "
        f"{share['kernel_n']} ({share['kernel_ms']:.3f} ms), copies "
        f"{share['gpu_memcpy_n']} ({share['gpu_memcpy_ms']:.3f} ms), memsets "
        f"{share['gpu_memset_n']} ({share['gpu_memset_ms']:.3f} ms); uploads "
        f"and result copies at once {share['copy_overlap_ms']:.3f} ms")
    return {"occupancy": {rid: r["occupancy"]
                          for rid, r in t["regions"].items()},
            "busy_share": share["busy_share"], "emit_us": emit_us,
            "medians": {str(k): v for k, v in med.items()}}


def _mega_images(dev, img):
    """The same padded image twice on the card: (M1's, plain's) ping/pong
    pairs."""
    import torch

    a = (torch.tensor(img, device=dev), torch.zeros(img.shape, device=dev))
    return a, tuple(x.clone() for x in a)


def _mega_step(kind, mine, plain, ctx, iters, budget, flag, boundary):
    """One launch of M1 and one of its plain version (the host loop
    through ``make_pipelined_chunk`` with B1, ``make_megakernel`` on the
    CPU's path) from ``ctx``, the flag at ``boundary``.  The context
    words, chunk counts and row blocks must be equal, the images bitwise
    (median) or within 1e-6 (gaussian).  Returns (context after, max abs
    error, M1's row blocks, M1's grid)."""
    import numpy as np
    import torch

    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.preemption import make_megakernel
    from repro_torch.kernels.blur import kernel as K
    from repro_torch.kernels.blur.tasks import KERNELS, task_ints

    flag.write(boundary)
    before = K.ROW_BLOCKS[kind]
    launch = K.blur_mega(ctx.to_words(), *mine, kind, iters, budget, flag)
    words, n = launch.result()
    rows = K.ROW_BLOCKS[kind] - before
    if flag.progress() != n:
        raise AssertionError(f"[mega] the progress word reads "
                             f"{flag.progress()} after {n} chunks")
    h, w = mine[0].shape[0] - 2, mine[0].shape[1] - 2
    want, _, want_n = make_megakernel(get_kernel(KERNELS[kind]))(
        ctx, plain, task_ints(h, w, iters), None, budget, flag).result()
    torch.cuda.synchronize()
    flag.clear()
    plain_rows = K.ROW_BLOCKS[kind] - before - rows
    if (n != want_n or not np.array_equal(words, want.to_words())
            or rows != plain_rows):
        raise AssertionError(
            f"[mega] {kind} [{h + 2}, {w + 2}] budget {budget} flag "
            f"{boundary}: M1 ran {n} chunks, {rows} row blocks, context "
            f"{words.tolist()}; the plain version {want_n}, {plain_rows}, "
            f"{want.to_words().tolist()}")
    err = max(check(kind, a, b) for a, b in zip(mine, plain))
    return want, err, rows, launch.grid


def _named_ms(fn, name: str, per_call: int, reps: int = 3,
              attempts: int = 3) -> float:
    """Device time of the kernels whose name holds ``name`` in one
    ``fn()``, in ms, under ``torch.profiler`` after a warm-up: the window
    must hold ``per_call`` of them a call, else it is profiled again (up
    to ``attempts`` times); 0.0 if no window was whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [v for k, v in _by_kernel(prof).items() if name in k]
        if sum(n for _, n in hits) >= per_call * reps:
            return sum(ms for ms, _ in hits) / reps
    return 0.0


def _drive_region(shell, task):
    """Run one task on region 0 of a shell directly, to its end."""
    from repro_torch.core.interrupts import EventKind

    region = shell.regions[0]
    region.enqueue_reconfig(task)
    region.enqueue_launch(task)
    deadline = time.perf_counter() + TIMEOUT_S
    while True:
        ev = shell.interrupts.wait(0.05)
        if time.perf_counter() > deadline:
            raise AssertionError(f"[mega] stuck: {task}")
        if ev is None or ev.kind in (EventKind.RECONFIG_DONE,
                                     EventKind.HEARTBEAT):
            continue
        if ev.kind is not EventKind.TASK_DONE:
            raise AssertionError(f"[mega] {ev.kind.name} before the end of "
                                 f"{task}")
        return


def _mega_lag(dev, flag, fresh, img) -> dict:
    """A flag write landing in a running M1 launch at budget 1 (a
    ``MEGA_LAG_ITERS``-iteration task of ``img``): the host writes the flag
    once the launch has published ``MEGA_LAG_AT`` chunks, reads the
    progress word right after and spins on the launch's event; the exit
    must come at most ``MEGA_LATE_CHUNKS`` past the progress read."""
    import torch

    from repro_torch.kernels.blur import kernel as K

    mine = (torch.tensor(img, device=dev), torch.zeros(img.shape, device=dev))
    lags = []
    for _ in range(MEGA_LAG_TRIALS):
        launch = K.blur_mega(fresh, *mine, "median", MEGA_LAG_ITERS, 1, flag)
        if not _wait(lambda: flag.progress() >= MEGA_LAG_AT, timeout=30):
            raise AssertionError("[mega] the lag launch never progressed")
        flag.write(1)
        t_w = time.perf_counter()
        at = flag.progress()
        while not launch.query():
            pass
        t_x = time.perf_counter()
        _, n = launch.result()
        flag.clear()
        lags.append(((t_x - t_w) * 1e6, n - at))
        total = MEGA_LAG_ITERS * launch.plan.n_rb  # a row block a chunk
        if not 0 <= n - at <= MEGA_LATE_CHUNKS or n >= total:
            raise AssertionError(f"[mega] M1: the flag exit came {n - at} "
                                 f"chunks after the write ({n} of {total} "
                                 f"run)")
    log(f"[mega] a flag write into a running M1 launch ({card_line()}; a "
        f"{img.shape[0] - 2}^2 task of {MEGA_LAG_ITERS} iterations at budget "
        f"1, written after {MEGA_LAG_AT} chunks): host write -> the launch's "
        f"event seen {[round(t, 3) for t, _ in lags]} us, chunks after the "
        f"device's published progress {[c for _, c in lags]} (at most "
        f"{MEGA_LATE_CHUNKS})")
    return {"flag_to_exit_us": [t for t, _ in lags],
            "chunks_past_progress": [c for _, c in lags]}


def mega_phase(rng, dev, imgs, b1_ms: dict) -> list:
    """5e. The megakernel engine and M1, the persistent blur kernel: M1
    against its plain version (every size, budget and kind; the flag at
    every boundary of a small task and at random ones of a 4096^2 task);
    a host ``request_preempt()`` and an ``inject_failure()`` mid-flight;
    the main path in megakernel mode, then 3 megakernel against 3
    pipelined runs; M1's device time per chunk and per task beside B1's
    and the bound, its grid and cap, and two regions' launches side by
    side.  Returns M1's kernel records."""
    import statistics
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import PreemptFlag, make_megakernel
    from repro_torch.core.region import _POLL_MAX_S
    from repro_torch.core.shell import Shell
    from repro_torch.kernels.blur import kernel as K
    from repro_torch.kernels.blur.tasks import (KERNELS, ROW_BLOCK,
                                                make_image, result_image,
                                                task_ints)
    from repro_torch.obs import Tracer, derive_metrics

    flag = PreemptFlag(dev)
    errs = {"median": 0.0, "gaussian": 0.0}

    # 5e.1 M1 against its plain version ------------------------------------
    n_checks = 0
    for kind in ("median", "gaussian"):
        for size in MEGA_SIZES:
            img = make_image(rng, size)
            n_rb = (img.shape[0] - 2) // ROW_BLOCK
            for budget in MEGA_BUDGETS:
                mine, plain = _mega_images(dev, img)
                ctx, err, rows, grid = _mega_step(
                    kind, mine, plain, ContextRecord.fresh(), MEGA_ITERS,
                    budget, flag, 0)
                errs[kind] = max(errs[kind], err)
                n_checks += 1
                if ctx.done != 1 or rows != MEGA_ITERS * n_rb:
                    raise AssertionError(
                        f"[mega] {kind} {size} budget {budget}: done "
                        f"{ctx.done}, {rows} row blocks, expected "
                        f"{MEGA_ITERS * n_rb}")
            log(f"[mega] {kind} {img.shape}: a whole {MEGA_ITERS}-iteration "
                f"task in one launch at budgets {MEGA_BUDGETS} equals the "
                f"plain version (context words, chunks, {MEGA_ITERS * n_rb} "
                f"row blocks; max_abs_err {errs[kind]:.3e}); grid "
                f"{grid} at budget {MEGA_BUDGETS[-1]}")
        # the flag at every boundary of a small task: boundary 1 of every
        # launch, then each boundary k of a fresh launch and its resume
        img = make_image(rng, MEGA_SIZES[0])
        mine, plain = _mega_images(dev, img)
        ctx, exits = ContextRecord.fresh(), 0
        while True:
            ctx, err, _, _ = _mega_step(kind, mine, plain, ctx, MEGA_ITERS,
                                        MEGA_SMALL_BUDGET, flag, 1)
            errs[kind] = max(errs[kind], err)
            n_checks += 1
            if ctx.done:
                break
            exits += 1
        for k in range(1, exits + 1):
            mine, plain = _mega_images(dev, img)
            ctx = ContextRecord.fresh()
            for boundary in (k, 0):
                ctx, err, _, _ = _mega_step(kind, mine, plain, ctx,
                                            MEGA_ITERS, MEGA_SMALL_BUDGET,
                                            flag, boundary)
                errs[kind] = max(errs[kind], err)
                n_checks += 1
            if ctx.done != 1:
                raise AssertionError(f"[mega] resume after boundary {k} "
                                     f"did not finish")
        # random boundaries of a 4096^2 task, resuming each time
        img = make_image(rng, SIZE)
        mine, plain = _mega_images(dev, img)
        ctx, arms = ContextRecord.fresh(), []
        while ctx.done == 0:
            arms.append(int(rng.integers(1, MEGA_RANDOM_MAX + 1)))
            ctx, err, _, _ = _mega_step(kind, mine, plain, ctx, MEGA_ITERS,
                                        RUN_BLOCKS, flag, arms[-1])
            errs[kind] = max(errs[kind], err)
            n_checks += 1
        del mine, plain
        log(f"[mega] {kind}: flag at each of the {exits + 1} boundaries of "
            f"a {MEGA_SIZES[0]}-pixel task (budget {MEGA_SMALL_BUDGET}) and "
            f"at random boundaries {arms} of a {SIZE}^2 task (budget "
            f"{RUN_BLOCKS}), resumed each time: equal after every exit")
    log(f"[mega] M1 against its plain version: {n_checks} launches, all "
        f"equal; max_abs_err {errs}")

    # 5e.2 a host request_preempt() mid-flight -------------------------------
    kd = get_kernel("MedianBlur")

    def big_task():
        from repro_torch.core.task import Task

        img = imgs[0]
        return Task(kernel="MedianBlur", args=kd.bundle(
            img, np.zeros_like(img), H=SIZE, W=SIZE,
            iters=MEGA_RESPONSE_ITERS))

    tracer = Tracer()
    shell = Shell(n_regions=1, chunk_budget=1, engine="megakernel",
                  prefetch=False, tracer=tracer)
    launched = threading.Event()
    try:
        region = shell.regions[0]
        calib = big_task()
        _drive_region(shell, calib)
        n_task = region.stats.chunks
        per_chunk_s = calib.run_s / n_task
        region.on_launch = lambda r, t: launched.set()
        tracer.clear()
        task = big_task()
        region.enqueue_reconfig(task)
        region.enqueue_launch(task)
        if not launched.wait(TIMEOUT_S):
            raise AssertionError("[mega] the launch never started")
        region.on_launch = None
        time.sleep(MEGA_REQUEST_AT * calib.run_s)
        region.request_preempt()
        t_req = time.perf_counter()
        # the chunks the device had published once the flag was written
        done_at_request = region.flag.progress()
        if not _wait(lambda: task.status.name in ("PREEMPTED", "DONE")):
            raise AssertionError("[mega] the preempted launch never ended")
        region.cancel_preempt()
        if task.status.name == "PREEMPTED":
            region.enqueue_reconfig(task)
            region.enqueue_launch(task)
        if not _wait(lambda: task.status.name == "DONE"):
            raise AssertionError("[mega] the resumed task never finished")
    finally:
        shell.shutdown()
    launches = [e for e in tracer.events() if e.kind == "mega_launch"]
    exited = launches[0]
    resp = derive_metrics(tracer.events())["preempt_response"]
    exit_s = exited.t + exited.dur - t_req
    # device time of one budget-1 chunk: the task's launch under the
    # profiler over its chunks
    mine, _ = _mega_images(dev, imgs[0])
    fresh = ContextRecord.fresh().to_words()

    def whole_task():
        K.blur_mega(fresh, *mine, "median", MEGA_RESPONSE_ITERS, 1, flag)

    task_ms = _named_ms(whole_task, "blur_mega", 1)
    how = "torch.profiler"
    if task_ms <= 0.0:
        task_ms, how = queued_ms(whole_task, reps=5), "queued behind a spin"
    chunk_dev_s = task_ms / 1e3 / n_task
    bound_s = chunk_dev_s + _POLL_MAX_S + MEGA_WAKE_SLACK_S
    late = exited.attrs["n_chunks"] - done_at_request
    log(f"[mega] request_preempt() {MEGA_REQUEST_AT:.0%} into a {SIZE}^2 "
        f"task of {MEGA_RESPONSE_ITERS} iterations at budget 1 ({n_task} "
        f"chunks; a launch {calib.run_s * 1e3:.3f} ms host, "
        f"{per_chunk_s * 1e6:.3f} us a chunk): the device had published "
        f"{done_at_request} chunks right after the host wrote the flag and "
        f"exited on it after {exited.attrs['n_chunks']} ({late} chunk(s) "
        f"later; at most {MEGA_LATE_CHUNKS}), done "
        f"{exited.attrs['done']}; request -> the host sees the flag exit "
        f"{exit_s * 1e6:.3f} us, request -> commit (preempt_response, n "
        f"{resp['n']}) {resp['max_s'] * 1e6:.3f} us; one chunk's device "
        f"time {chunk_dev_s * 1e6:.3f} us ({how}: {task_ms:.6f} ms a task); "
        f"bound one chunk + poll backoff {_POLL_MAX_S * 1e6:.0f} us + wake "
        f"slack {MEGA_WAKE_SLACK_S * 1e6:.0f} us = {bound_s * 1e6:.3f} us")
    if (exited.attrs["done"] != 0 or resp["n"] != 1
            or not 0 <= late <= MEGA_LATE_CHUNKS
            or not 0.0 < exit_s <= bound_s):
        raise AssertionError(f"[mega] preempt response {exit_s:.6f} s "
                             f"(bound {bound_s:.6f} s), {late} chunks after "
                             f"the request, done {exited.attrs['done']}, "
                             f"responses {resp['n']}")
    check("median", torch.tensor(result_image(task, MEGA_RESPONSE_ITERS)),
          _plain_image(imgs[0], MEGA_RESPONSE_ITERS, "MedianBlur", dev))
    log("[mega] the preempted task resumed and equals the plain version")

    # 5e.3 inject_failure() mid-flight ---------------------------------------
    tracer = Tracer()
    client = repro_torch.Client(n_regions=2, chunk_budget=1,
                                engine="megakernel", tracer=tracer)
    launched.clear()
    first = []
    try:
        def on_launch(r, t):
            if not first:
                first.append(r)
                launched.set()

        for r in client.shell.regions:
            r.on_launch = on_launch
        task = big_task()
        h = client.submit(task)
        if not launched.wait(TIMEOUT_S):
            raise AssertionError("[mega] the launch never started")
        time.sleep(MEGA_REQUEST_AT * calib.run_s)
        first[0].inject_failure()
        t_inj = time.perf_counter()
        done_at_failure = first[0].flag.progress()
        h.result(timeout=TIMEOUT_S)
        rep = client.report()
        late = first[0].flag.progress() - done_at_failure
    finally:
        client.shutdown()
    failed = [e for e in tracer.events() if e.kind == "region_failed"]
    pop_s = failed[0].t - t_inj if failed else float("inf")
    check("median", torch.tensor(result_image(task, MEGA_RESPONSE_ITERS)),
          _plain_image(imgs[0], MEGA_RESPONSE_ITERS, "MedianBlur", dev))
    log(f"[mega] inject_failure() on region {first[0].rid} mid-flight, "
        f"{done_at_failure} chunks into the launch: it popped {late} "
        f"chunk(s) later, and the host raised the failure "
        f"{pop_s * 1e6:.3f} us after the injection (bound "
        f"{bound_s * 1e6:.3f} us); the task recovered on regions "
        f"{task.region_history} ({task.n_migrations} migration(s), "
        f"megakernel_launches {rep['megakernel_launches']}) and equals the "
        f"plain version")
    if (not 0.0 < pop_s <= bound_s or not 0 <= late <= MEGA_LATE_CHUNKS
            or len(set(task.region_history)) != 2):
        raise AssertionError(f"[mega] failure popped in {pop_s:.6f} s "
                             f"(bound {bound_s:.6f}), {late} chunks after "
                             f"it; regions {task.region_history}")

    # 5e.4 the main path in megakernel mode ----------------------------------
    tasks, urgent, rep, wall_s, (blocks, b1, m1) = serve(
        imgs, 0.0, engine="megakernel")
    want = _want_blocks([("MedianBlur", BG_ITERS), ("MedianBlur", BG_ITERS),
                         ("GaussianBlur", URGENT_ITERS)])
    log_serve("mega", tasks, urgent, rep, wall_s, 0.0)
    log(f"[mega] main path: megakernel_launches {rep['megakernel_launches']}, "
        f"flag_poll_exits {rep['flag_poll_exits']}, preemptions "
        f"{rep['preemptions']}; row blocks {blocks} (expected exactly "
        f"{want}); M1 launches {m1}, B1 launches {b1}")
    if (rep["megakernel_launches"] < 1 or rep["flag_poll_exits"] < 1
            or blocks != want or min(m1.values()) < 1 or sum(b1.values())):
        raise AssertionError(f"[mega] main path: launches "
                             f"{rep['megakernel_launches']}, flag exits "
                             f"{rep['flag_poll_exits']}, row blocks {blocks} "
                             f"against {want}, M1 {m1}, B1 {b1}")
    for t, im, iters in ((tasks[0], imgs[0], BG_ITERS),
                         (tasks[1], imgs[1], BG_ITERS),
                         (urgent, imgs[2], URGENT_ITERS)):
        err = _check_result(t, im, iters, dev)
        log(f"[mega] task #{t.tid} {t.kernel} x{iters}: preempted "
            f"{t.n_preemptions}x on regions {t.region_history}, max_abs_err "
            f"{err:.3e}")
    arms = {"pipelined": [], "megakernel": []}
    for engine in MEGA_AB:
        a_tasks, a_urgent, a_rep, a_wall, _ = serve(imgs, 0.0, engine=engine)
        every = (*a_tasks, a_urgent)
        arms[engine].append((a_wall * 1e3,
                             sum(x.run_s for x in every) / len(every) * 1e3,
                             a_urgent.service_time * 1e3))
        log(f"[mega] {engine} run: wall {a_wall * 1e3:.3f} ms, host per task "
            f"{arms[engine][-1][1]:.4f} ms ({a_rep['chunks']} chunks, "
            f"{a_rep['megakernel_launches']} megakernel launches, flag exits "
            f"{a_rep['flag_poll_exits']}), urgent service "
            f"{a_urgent.service_time * 1e3:.3f} ms, preemptions "
            f"{a_rep['preemptions']}")
    with tempfile.TemporaryDirectory() as tmp:
        prof_json = str(Path(tmp) / "profile.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, p_urgent, _, p_wall, _ = serve(imgs, 0.0, window="mega_window",
                                              engine="megakernel")
        prof.export_chrome_trace(prof_json)
        share = _busy_share(prof_json, "mega_window")
    log(f"[mega] torch.profiler over one more megakernel run, first "
        f"submission to last result ({p_wall * 1e3:.3f} ms wall, urgent "
        f"service {p_urgent.service_time * 1e3:.3f} ms): card busy "
        f"{share['busy_ms']:.3f} ms of {share['window_ms']:.3f}, busy share "
        f"{share['busy_share']:.4f}; kernels {share['kernel_n']} "
        f"({share['kernel_ms']:.3f} ms), copies {share['gpu_memcpy_n']} "
        f"({share['gpu_memcpy_ms']:.3f} ms); uploads and result copies at "
        f"once {share['copy_overlap_ms']:.3f} ms")
    for engine, runs in arms.items():
        parts = []
        for i, name in enumerate(("wall", "host per task",
                                  "urgent service")):
            xs = [r[i] for r in runs]
            parts.append(f"{name} median {statistics.median(xs):.4f} ms, "
                         f"range {min(xs):.4f}-{max(xs):.4f}")
        log(f"[mega] {engine}, {len(runs)} runs: " + "; ".join(parts))

    # 5e.5 what a chunk is made of, then the device time per chunk and task
    mine, plain = _mega_images(dev, imgs[1])
    card = card_line()
    probes = {}
    for budget in MEGA_TIME_BUDGETS:
        pr = K.latency_probe(*mine, "median", budget, flag,
                             reps=MEGA_PROBE_REPS)
        probes[budget] = pr
        log(f"[mega] blur_latency_probe ({card}), median, budget {budget}, "
            f"M1's grid {pr['grid']['grid']} blocks of 128 (the watcher "
            f"included), {MEGA_PROBE_REPS} reps a part: a pass's run of "
            f"{budget} row blocks {pr['run']:.4f} us, a grid sync "
            f"{pr['grid_sync']:.4f} us, the earlier boundary (grid sync, "
            f"volatile progress store and ld.acquire.sys flag read by one "
            f"thread, grid sync) {pr['parent_boundary']:.4f} us, the "
            f"watcher's ld.relaxed.sys flag read {pr['flag_relaxed']:.4f} "
            f"us, a hand-off round (every block's red.release.gpu seen by "
            f"the watcher's ld.acquire.gpu, its tag seen by the blocks) "
            f"{pr['handoff_round']:.4f} us; the earlier chunk by its parts "
            f"(run + grid sync + boundary) "
            f"{pr['run'] + pr['grid_sync'] + pr['parent_boundary']:.4f} us")
    fresh = ContextRecord.fresh().to_words()
    ints = task_ints(SIZE, SIZE, BG_ITERS)
    rows = RUN_BLOCKS * ROW_BLOCK
    nbytes = ((rows + 2) * (SIZE + 2) + rows * SIZE) * 4
    weight = torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]],
                          device=dev).div(16.0).view(1, 1, 3, 3)
    conv_src = mine[0][None, None, :rows + 2]
    records = []
    timed = {"median": [], "gaussian": []}
    for kind in ("median", "gaussian", "gaussian", "median"):
        plain_entry = make_megakernel(get_kernel(KERNELS[kind]))

        def plain_task(kind=kind):
            plain_entry(ContextRecord.fresh(), plain, ints, None, RUN_BLOCKS,
                        flag)

        arms = {"plain": (plain_task, "blur_rows",
                          BG_ITERS * (SIZE // ROW_BLOCK) // RUN_BLOCKS)}
        for budget in MEGA_TIME_BUDGETS:
            arms[f"M1/{budget}"] = (
                lambda kind=kind, budget=budget: K.blur_mega(
                    fresh, *mine, kind, BG_ITERS, budget, flag),
                "blur_mega", 1)
        dev_ms, wall_ms, hows = {}, {}, {}
        for arm, (fn, name, n_launch) in arms.items():
            wall_ms[arm] = cuda_time_ms(fn, reps=10)
            dev_ms[arm] = _named_ms(fn, name, n_launch)
            hows[arm] = "torch.profiler"
            # a profiler window that caught part of a persistent launch
            # reads short of the launch's back-to-back event time
            if dev_ms[arm] <= 0.0 or (name == "blur_mega"
                                      and dev_ms[arm] < 0.75 * wall_ms[arm]):
                dev_ms[arm] = queued_ms(fn, reps=5)
                hows[arm] = "queued behind a spin kernel"
        if kind == "gaussian":
            def conv():
                return F.conv2d(conv_src, weight)

            dev_ms["library"] = device_ms(conv)
            if dev_ms["library"] <= 0.0:
                dev_ms["library"] = queued_ms(conv)
        launch = arms[f"M1/{RUN_BLOCKS}"][0]()
        launch.result()
        grid, plan = launch.grid, launch.plan
        n_chunks = {b: len(list(K.mega_plan(SIZE, SIZE, BG_ITERS, b, fresh)
                                .chunks())) for b in MEGA_TIME_BUDGETS}
        bound = (nbytes / HBM_BYTES_PER_S * 1e3,
                 OPS_PER_PIXEL[kind] * rows * SIZE / F32_OPS_PER_S * 1e3)
        per = {b: dev_ms[f"M1/{b}"] / n_chunks[b] for b in MEGA_TIME_BUDGETS}
        floor = {b: max(probes[b]["run"], probes[b]["flag_relaxed"])
                 for b in MEGA_TIME_BUDGETS}
        n8 = n_chunks[RUN_BLOCKS]
        log(f"[mega] {kind} M1 ({card}): a {BG_ITERS}-iteration {SIZE}^2 "
            f"task " + ", ".join(
                f"at budget {b}: {dev_ms[f'M1/{b}']:.6f} ms device "
                f"({hows[f'M1/{b}']}), {per[b] * 1e3:.4f} us a chunk of "
                f"{n_chunks[b]}" for b in MEGA_TIME_BUDGETS)
            + "; the floor a chunk measured in this run (the probe's run "
            "alone, or one flag read where longer): " + ", ".join(
                f"budget {b} {floor[b]:.4f} us" for b in MEGA_TIME_BUDGETS)
            + f"; {launch.waits} grid-wide waits a launch at budget "
            f"{RUN_BLOCKS} (the plan's pass ends, {plan.totals(n8)[1]}); "
            f"B1's {RUN_BLOCKS}-block run {b1_ms[kind] * 1e3:.4f} us; bound "
            f"{max(bound) * 1e3:.4f} us a chunk of {RUN_BLOCKS} (bytes "
            f"{bound[0] * 1e3:.4f}, operations {bound[1] * 1e3:.4f}); the "
            f"plain version (host loop, {n8} B1 launches) "
            f"{dev_ms['plain'] / n8 * 1e3:.4f} us device a chunk "
            f"({hows['plain']}); "
            + (f"conv2d over a chunk's {rows + 2} rows "
               f"{dev_ms['library'] * 1e3:.4f} us; " if kind == "gaussian"
               else "")
            + "wall a task (CUDA events, back to back) " + ", ".join(
                f"M1 budget {b} {wall_ms[f'M1/{b}']:.4f} ms"
                for b in MEGA_TIME_BUDGETS)
            + f", plain {wall_ms['plain']:.4f} ms; grid {grid['grid']} "
            f"blocks of 128 ({grid['grid'] - 1} computing and the watcher), "
            f"cap {grid['cap']} (half of the {grid['coresident']} the card "
            f"holds at once)")
        timed[kind].append(dev_ms)
        if len(timed[kind]) < 2:
            continue
        # the record: the mean of the kind's two timings
        dev_ms = {arm: sum(d[arm] for d in timed[kind]) / 2
                  for arm in timed[kind][0]}
        records.append({
            "name": f"blur_mega_{kind}", "route": "cuda",
            "source": "src/repro_torch/csrc/blur.cu",
            "replaces": REPLACES_MEGA,
            "counterpart_of": "make_megakernel (a lax.while_loop over the "
                              "blur task, not a pallas_call)",
            "launches": m1[kind], "max_abs_err": errs[kind],
            "ms": dev_ms[f"M1/{RUN_BLOCKS}"] / n8,
            "per": f"chunk of {RUN_BLOCKS} row blocks",
            "ms_per_task": dev_ms[f"M1/{RUN_BLOCKS}"],
            "plain_ms": dev_ms["plain"] / n8,
            "bound_ms": max(bound),
            "bound_by": "bytes" if bound[0] >= bound[1] else "operations",
            "library_ms": dev_ms.get("library"), "grid": grid})
    _mega_lag(dev, flag, fresh, imgs[1])

    # two regions' launches side by side: the cap leaves the other room
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    pairs = [mine, plain]
    flags = [flag, PreemptFlag(dev)]

    def on(i):
        with torch.cuda.stream(streams[i]):
            return K.blur_mega(fresh, *pairs[i], "median", BG_ITERS,
                               RUN_BLOCKS, flags[i])

    warm = on(0)
    warm.result()
    side_grid = warm.grid
    on(1).result()

    def timed(launch):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        handles = launch()
        for h in handles:
            h.result()
        return time.perf_counter() - t0, handles

    # alone and both interleaved, and each the median of its reps: a host
    # hiccup in one rep (the host is shared) moves neither median.  Each
    # pair's overlap on the card: the later first-block start to the
    # earlier last-block end (%globaltimer)
    alones, boths, overlaps = [], [], []
    for _ in range(MEGA_SIDE_REPS):
        alones.append(timed(lambda: (on(0),))[0])
        dt, (h0, h1) = timed(lambda: (on(0), on(1)))
        boths.append(dt)
        overlaps.append((min(h0.interval[1], h1.interval[1])
                         - max(h0.interval[0], h1.interval[0])) / 1e3)
    alone, both = statistics.median(alones), statistics.median(boths)
    log(f"[mega] two regions' M1 launches (each grid "
        f"{side_grid['grid']}) on two streams at once ({card}): median "
        f"{both * 1e3:.4f} ms for both (range {min(boths) * 1e3:.4f}-"
        f"{max(boths) * 1e3:.4f}) against {alone * 1e3:.4f} ms for one "
        f"alone (range {min(alones) * 1e3:.4f}-{max(alones) * 1e3:.4f}), "
        f"{MEGA_SIDE_REPS} interleaved reps each (ratio {both / alone:.3f}; "
        f"one after the other would be about 2); the two launches ran at "
        f"once for median {statistics.median(overlaps):.3f} us of each "
        f"pair (range {min(overlaps):.3f}-{max(overlaps):.3f}; overlapping "
        f"in {sum(o > 0 for o in overlaps)} of {MEGA_SIDE_REPS} pairs)")
    if both / alone >= MEGA_SIDE_MAX:
        raise AssertionError(f"[mega] two regions' launches took "
                             f"{both / alone:.3f}x one's: the second region "
                             f"waited")
    return records


class _HopClock:
    """Host-clock split of a frontend's cross-shell hops: wraps its
    ``_take_task`` (request -> handoff), ``_spill_roundtrip`` (materialize
    + save + load) and ``_resubmit`` on the instance, and the store's
    ``save_pytree``/``load_pytree`` as the frontend module imported them,
    until ``close()``.  Measurement only: each wrapper calls the original
    and records its duration, its end and any exception."""

    def __init__(self, fe):
        import repro_torch.cluster.frontend as F

        self._mod = F
        self._store = (F.save_pytree, F.load_pytree)
        self.s: dict = {}
        self.end: dict = {}
        self.errors: list = []
        fe._take_task = self._timed("handoff", fe._take_task)
        fe._spill_roundtrip = self._timed("spill", fe._spill_roundtrip)
        fe._resubmit = self._timed("resubmit", fe._resubmit)
        F.save_pytree = self._timed("save", F.save_pytree)
        F.load_pytree = self._timed("load", F.load_pytree)

    def _timed(self, name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            except BaseException as e:
                self.errors.append((name, repr(e)))
                raise
            finally:
                self.end[name] = time.perf_counter()
                self.s[name] = self.s.get(name, 0.0) + self.end[name] - t0
        return run

    def close(self):
        self._mod.save_pytree, self._mod.load_pytree = self._store


def _cluster_report_line(rep) -> dict:
    keys = ("n_shells", "router", "n_submitted", "n_done", "wall_s",
            "throughput_tps", "turnaround_p50_s", "turnaround_p99_s",
            "migrations_attempted", "migrations_completed", "failovers",
            "lost_tasks", "stranded_handles", "dead_shells",
            "energy_j_total")
    shell_keys = ("n_done", "preemptions", "migrations", "migrated_out",
                  "healthy", "reconfigs", "utilization")
    out = {k: rep[k] for k in keys}
    out["per_shell"] = {n: {k: s[k] for k in shell_keys}
                        for n, s in rep["per_shell"].items()}
    return out


def _cluster_hop(rng, dev, engine: str) -> dict:
    """5f (2, 3). A forced running migration of a priority-4 MedianBlur
    (3 iterations, 4096^2) from shell 0 to shell 1 of a
    ``ClusterFrontend(n_shells=2, regions_per_shell=1, chunk_budget=8)``.
    Pipelined: the region's ``on_chunk`` holds the worker at the task's
    ``CLUSTER_HOP_AT``-th chunk boundary until the migrator has asked for
    the preemption, so the commit lands exactly there.  Megakernel: its
    ``on_launch`` holds the M1 launch until the migrator's request has
    written the flag, so the launch exits through the flag after its first
    chunk.  ``fe.migrate`` is called from this thread, never from a hook
    (it blocks until the handoff, which needs the held worker)."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.ckpt.store import load_pytree
    from repro_torch.cluster import ClusterFrontend
    from repro_torch.core.context import ContextRecord
    from repro_torch.kernels.blur.tasks import make_image

    tag = f"cluster, {engine} hop"
    spill = tempfile.mkdtemp(prefix="cluster-spill-")
    fe = ClusterFrontend(n_shells=2, regions_per_shell=1,
                         chunk_budget=RUN_BLOCKS, engine=engine,
                         spill_dir=spill)
    img = make_image(rng, SIZE)
    task = _blur_task("MedianBlur", img, BG_ITERS, 4)
    src, dst = (n.shell.regions for n in fe.nodes)
    hold_at = CLUSTER_HOP_AT if engine == "pipelined" else 1
    reached, seen, marks = threading.Event(), [0], {}

    def hook(region, t):
        if t.tid != task.tid:
            return
        if region in dst:
            marks.setdefault("dst_first", time.perf_counter())
            return
        if reached.is_set():
            return
        seen[0] += 1
        if seen[0] == hold_at:
            reached.set()
            marks["held"] = _wait(region._preempt.is_set)

    for r in (*src, *dst):
        r.on_chunk = r.on_launch = hook
    clock = _HopClock(fe)
    try:
        _reset_counts()
        h = fe.submit(task)
        if not reached.wait(TIMEOUT_S):
            raise AssertionError(f"[{tag}] the task never reached its hold")
        t0 = time.perf_counter()
        moved = fe.migrate(tid=task.tid)
        hop_s = time.perf_counter() - t0
        result = h.result(timeout=TIMEOUT_S)
        blocks, launches, mega = _counts()
        src_stats, dst_stats = src[0].stats, dst[0].stats
        names = sorted(f for f in os.listdir(spill) if f.endswith(".npz"))
        nbytes = {f: os.path.getsize(os.path.join(spill, f))
                  + os.path.getsize(os.path.join(spill, f + ".json"))
                  for f in names}
        # the spill's CRCs, checked once more from the file as it stands
        bufs, _, _ = task.args.padded()
        for f in names:
            load_pytree(os.path.join(spill, f),
                        {"context": ContextRecord.fresh(),
                         "payload": tuple(bufs)})
    finally:
        clock.close()
        rep = fe.shutdown()
        shutil.rmtree(spill, ignore_errors=True)
    if not moved or h.n_migrations != 1 or h.node_history != [0, 1]:
        raise AssertionError(f"[{tag}] migrate -> {moved}, n_migrations "
                             f"{h.n_migrations}, shells {h.node_history}")
    if clock.errors or len(names) != 1:
        # a CheckpointCorruptError would restart the task from scratch
        raise AssertionError(f"[{tag}] spill errors {clock.errors}, spill "
                             f"files {names}")
    if rep["lost_tasks"] or rep["stranded_handles"] or not marks["held"]:
        raise AssertionError(f"[{tag}] {_cluster_report_line(rep)}, held "
                             f"{marks['held']}")
    want_blocks = _want_blocks((("MedianBlur", BG_ITERS),))
    if engine == "pipelined":
        if blocks != want_blocks or any(mega.values()):
            raise AssertionError(f"[{tag}] row blocks {blocks} != "
                                 f"{want_blocks} or M1 launched {mega}")
    elif (any(launches.values()) or mega != {"median": 2, "gaussian": 0}
          or src_stats.flag_poll_exits < 1):
        raise AssertionError(f"[{tag}] B1 launches {launches}, M1 launches "
                             f"{mega}, flag exits on shell 0 "
                             f"{src_stats.flag_poll_exits}")
    for i, (name, want) in enumerate(zip(("ping", "pong"),
                                         _unpreempted(task, dev))):
        if not np.array_equal(result[i], want):
            raise AssertionError(f"[{tag}] the migrated task's {name} "
                                 f"differs from the unpreempted run")
    err = _check_result(h.task, img, BG_ITERS, dev)
    split = {
        "request_to_handoff_ms": clock.s["handoff"] * 1e3,
        "materialize_ms": (clock.s["spill"] - clock.s["save"]
                           - clock.s["load"]) * 1e3,
        "save_pytree_ms": clock.s["save"] * 1e3,
        "load_pytree_ms": clock.s["load"] * 1e3,
        "resubmit_to_first_chunk_ms": (marks["dst_first"]
                                       - clock.end["resubmit"]) * 1e3,
        "migrate_call_ms": hop_s * 1e3,
        "spill_bytes": sum(nbytes.values()),
    }
    where = (f"chunk boundary {src_stats.chunks} (held at "
             f"{CLUSTER_HOP_AT}; the chunk in flight is retired first)"
             if engine == "pipelined"
             else "the launch's first chunk boundary, through the flag")
    log(f"[{tag}] task #{task.tid}: shells {h.node_history}, migrated at "
        f"{where}, chunks {src_stats.chunks} on shell 0 + {dst_stats.chunks} on "
        f"shell 1, flag exits {src_stats.flag_poll_exits}, megakernel "
        f"launches {src_stats.megakernel_launches} + "
        f"{dst_stats.megakernel_launches}; row blocks {blocks}, B1 launches "
        f"{launches}, M1 launches {mega}; (ping, pong) bitwise the "
        f"unpreempted run, max_abs_err vs plain {err:.3e}; spill {names} "
        f"CRC-verified")
    log(f"[{tag}] hop split (host clock): {json.dumps(split)}")
    return split


def cluster_phase(rng, dev, imgs) -> dict:
    """5f. The cluster fabric and the checkpoint store on cuda:0: two
    shells of one region each (every region a CUDA stream on the one
    card).  (1) The main path's mix through ``ClusterFrontend(n_shells=2,
    regions_per_shell=1, chunk_budget=8)``: every image equal to the plain
    version's, row blocks exact, the placement and ``report()``'s cluster
    keys printed.  (2) A forced running migration in the pipelined engine
    (``_cluster_hop``): n_migrations 1, the spill CRC-verified, (ping,
    pong) bitwise an unpreempted run, row blocks exact, and the hop's
    split on the host clock with the spill's bytes.  (3) The same hop in
    megakernel mode: M1 preempted through the flag, resumed on the other
    shell, bitwise, no B1 launch.  (4) Failover: ``inject_failure()`` on
    shell 0 at its task's ``CLUSTER_FAIL_AT``-th chunk boundary (held
    there by ``on_chunk``): every handle resolves, nothing lost or
    stranded, every image bitwise; the killed task restarts from scratch
    on shell 1 (it was never preempted, so its bank has no commit), so
    the median row blocks exceed the exact count by the chunks it had
    launched on shell 0, at most ``CLUSTER_FAIL_AT + 1`` chunks of 8 (the
    pipelined engine has the next chunk in flight when the hook fires).
    (5) The ``[overhead]`` stream (seed 15, 12 tasks) as one burst through
    1 shell, 2 shells, and 2 shells with one forced migration (the
    reference's ``measure_cluster`` arms): images equal the plain
    version's, migrated tasks bitwise the 1-shell arm's, row blocks exact;
    turnaround p50/p99 printed, no speed asserted (both shells share one
    card and one host's pageable copies)."""
    import numpy as np

    from repro_torch.cluster import ClusterFrontend
    from repro_torch.core.task import Task
    from repro_torch.kernels.blur.tasks import make_image

    out = {}
    # (1) serve and route -------------------------------------------------
    fe = ClusterFrontend(n_shells=2, regions_per_shell=1,
                         chunk_budget=RUN_BLOCKS)
    tasks = [_blur_task("MedianBlur", imgs[i], BG_ITERS, 4) for i in (0, 1)]
    urgent = _blur_task("GaussianBlur", imgs[2], URGENT_ITERS, 0)
    started, both = set(), threading.Event()

    def on_chunk(region, t):
        started.add(t.tid)
        if all(b.tid in started for b in tasks):
            both.set()

    for node in fe.nodes:
        for r in node.shell.regions:
            r.on_chunk = on_chunk
    try:
        _reset_counts()
        t0 = time.perf_counter()
        handles = [fe.submit(t) for t in tasks]
        if not both.wait(TIMEOUT_S):
            raise AssertionError("[cluster] background tasks never retired "
                                 "a chunk")
        handles.append(fe.submit(urgent))
        for h in handles:
            h.result(timeout=TIMEOUT_S)
        wall_s = time.perf_counter() - t0
        _require_counts("cluster", _want_blocks(
            (("MedianBlur", BG_ITERS), ("MedianBlur", BG_ITERS),
             ("GaussianBlur", URGENT_ITERS))))
    finally:
        rep = fe.shutdown()
    if rep["n_done"] != 3 or rep["lost_tasks"] or rep["stranded_handles"]:
        raise AssertionError(f"[cluster] {_cluster_report_line(rep)}")
    for h, im, iters in zip(handles, imgs,
                            (BG_ITERS, BG_ITERS, URGENT_ITERS)):
        err = _check_result(h.task, im, iters, dev)
        log(f"[cluster] route: task #{h.tid} {h.task.kernel} x{iters} "
            f"(priority {h.task.priority}) -> shell {h.node_history}, "
            f"preempted {h.task.n_preemptions}x, max_abs_err {err:.3e}")
    out["route"] = _cluster_report_line(rep)
    log(f"[cluster] route: 3 tasks in {wall_s:.3f} s; report "
        f"{json.dumps(out['route'])}")

    # (2), (3) the hops --------------------------------------------------
    out["hop_pipelined"] = _cluster_hop(rng, dev, "pipelined")
    out["hop_megakernel"] = _cluster_hop(rng, dev, "megakernel")

    # (4) failover --------------------------------------------------------
    fe = ClusterFrontend(n_shells=2, regions_per_shell=1,
                         chunk_budget=RUN_BLOCKS)
    specs = (("MedianBlur", BG_ITERS), ("MedianBlur", BG_ITERS),
             ("GaussianBlur", URGENT_ITERS))
    fimgs = [make_image(rng, SIZE) for _ in specs]
    ftasks = [_blur_task(k, im, it, 4) for (k, it), im in zip(specs, fimgs)]
    victim, survivor = fe.nodes[0].shell.regions, fe.nodes[1].shell.regions
    reached, seen, marks = threading.Event(), [0], {}

    def kill_hook(region, t):
        if t.tid != ftasks[0].tid:
            return
        if region in survivor:
            marks.setdefault("readmitted_first", time.perf_counter())
            return
        seen[0] += 1
        if seen[0] == CLUSTER_FAIL_AT:
            reached.set()
            marks["held"] = _wait(region._failed.is_set)

    for r in (*victim, *survivor):
        r.on_chunk = kill_hook
    try:
        _reset_counts()
        handles = [fe.submit(t) for t in ftasks]   # shells 0, 1, 0
        if not reached.wait(TIMEOUT_S):
            raise AssertionError("[cluster, failover] the task never "
                                 "reached its hold")
        t_inject = time.perf_counter()
        fe.nodes[0].inject_failure()
        for h in handles:
            h.result(timeout=TIMEOUT_S)
        blocks, _, _ = _counts()
        events = list(fe.failover_events)
        t0_fe = fe._t0
    finally:
        rep = fe.shutdown()
    exact = _want_blocks(specs)
    extra = blocks["median"] - exact["median"]
    bound = (CLUSTER_FAIL_AT + 1) * RUN_BLOCKS
    if (rep["failovers"] != 1 or rep["lost_tasks"]
            or rep["stranded_handles"] or len(events) != 1
            or events[0]["readmitted"] != 2 or not marks["held"]):
        raise AssertionError(f"[cluster, failover] {events}, "
                             f"{_cluster_report_line(rep)}")
    if blocks["gaussian"] != exact["gaussian"] or not 0 < extra <= bound:
        raise AssertionError(f"[cluster, failover] row blocks {blocks}: "
                             f"exact {exact}, median extra {extra} not in "
                             f"(0, {bound}]")
    for h, (k, it), im in zip(handles, specs, fimgs):
        err = _check_result(h.task, im, it, dev)
        log(f"[cluster, failover] task #{h.tid} {k} x{it}: shells "
            f"{h.node_history}, failovers {h.n_failovers}, max_abs_err "
            f"{err:.3e}")
    out["failover"] = {
        "inject_to_readmit_ms": (t0_fe + events[0]["t_s"] - t_inject) * 1e3,
        "inject_to_first_chunk_ms": (marks["readmitted_first"]
                                     - t_inject) * 1e3,
        "failover_events": events,
        "median_row_blocks_rerun": extra, "rerun_bound": bound}
    log(f"[cluster, failover] shell 0 killed at chunk boundary "
        f"{CLUSTER_FAIL_AT} of task #{ftasks[0].tid}: "
        f"{json.dumps(out['failover'])}; row blocks {blocks} (exact "
        f"{exact} + the killed task's {extra} re-run, bound {bound})")

    # (5) 1 shell against 2 -------------------------------------------------
    stream, iters, want = _harness_stream(OVERHEAD_SEED, dev)

    def arm(n_shells: int, migrate: bool):
        fe = ClusterFrontend(n_shells=n_shells, regions_per_shell=1,
                             rebalance=False)
        try:
            for node in fe.nodes:
                for kname in ("MedianBlur", "GaussianBlur"):
                    node.shell.engine.prewarm(
                        kname, stream[0].args,
                        node.shell.regions[0].geometry)
            tasks = [Task(kernel=t.kernel, args=t.args, priority=t.priority)
                     for t in stream]   # one burst: every arrival at once
            handles = [fe.submit(t) for t in tasks]
            forced = 0
            if migrate:
                deadline = time.perf_counter() + CLUSTER_MIGRATE_WAIT_S
                while not forced and time.perf_counter() < deadline:
                    forced = int(fe.migrate(prefer="running"))
                    time.sleep(0.005)
            results = [h.result(timeout=TIMEOUT_S) for h in handles]
        finally:
            rep = fe.shutdown()
        _check_stream("cluster, arms", [h.task for h in handles], iters,
                      want)
        if (rep["n_done"] != len(stream) or rep["lost_tasks"]
                or rep["stranded_handles"] or forced != int(migrate)):
            raise AssertionError(f"[cluster, arms] forced {forced}: "
                                 f"{_cluster_report_line(rep)}")
        migrated = [i for i, h in enumerate(handles) if h.n_migrations]
        return rep, results, migrated

    _reset_counts()
    arms = {}
    for name, n_shells, migrate in (("1shell", 1, False),
                                    ("2shell", 2, False),
                                    ("2shell-migrate", 2, True)):
        rep, results, migrated = arm(n_shells, migrate)
        arms[name] = (rep, results, migrated)
        log(f"[cluster, arms] {name}: {rep['n_done']} tasks, turnaround "
            f"p50 {rep['turnaround_p50_s'] * 1e3:.3f} ms, p99 "
            f"{rep['turnaround_p99_s'] * 1e3:.3f} ms, {rep['throughput_tps']:.4f} "
            f"tasks/s over {rep['wall_s']:.3f} s, migrations "
            f"{rep['migrations_completed']}, per-shell n_done "
            f"{[s['n_done'] for s in rep['per_shell'].values()]}, migrated "
            f"tasks {migrated}")
    _require_counts("cluster, arms", {
        k: 3 * v for k, v in _want_blocks(
            (t.kernel, it) for t, it in zip(stream, iters)).items()})
    ref = arms["1shell"][1]
    _, results, migrated = arms["2shell-migrate"]
    identical = bool(migrated) and all(
        np.array_equal(a, b) for i in migrated
        for a, b in zip(results[i], ref[i]))
    if not identical:
        raise AssertionError(f"[cluster, arms] migrated tasks {migrated} "
                             f"differ from the 1-shell arm")
    p99 = {n: a[0]["turnaround_p99_s"] for n, a in arms.items()}
    out["arms"] = {n: {k: a[0][k] for k in (
        "turnaround_p50_s", "turnaround_p99_s", "throughput_tps", "wall_s",
        "migrations_completed")} for n, a in arms.items()}
    out["arms"]["p99_2shell_over_1shell"] = p99["2shell"] / p99["1shell"]
    out["arms"]["migrated_bit_identical"] = identical
    log(f"[cluster, arms] p99 2 shells / 1 shell "
        f"{out['arms']['p99_2shell_over_1shell']:.4f} (the reference's bar "
        f"is <= 0.75 on separate shells; here both share one card and one "
        f"host), migrated_bit_identical {identical}")
    return out


def serving_traffic():
    """16 sequences from seed 0: prompts of 8-96 tokens, 8-32 new tokens,
    with prompt + new - 1 <= max_ctx (every sequence fits its pages)."""
    import numpy as np

    rng = np.random.default_rng(0)
    seqs = []
    for _ in range(N_SEQS):
        n = int(rng.integers(8, 97))
        new = int(rng.integers(8, 33))
        new = min(new, SERVING["max_ctx"] + 1 - n)
        seqs.append(([int(t) for t in rng.integers(0, SERVING["vocab_size"],
                                                     size=n)], new))
    return seqs


def serve_attention(traffic, trace: bool = False, tracer=None, metrics=None,
                    engine: str = "pipelined"):
    """The main path of token serving: ``Client.stream`` on cuda:0 through
    both attention kernels (pipelined: B2/B3 a chunk; megakernel: one
    M4/M5 launch a dispatch), with every 3rd decode round preempted at its
    2nd chunk (pipelined: ``request_preempt`` after its 2nd chunk;
    megakernel: its first launch armed through ``on_launch`` to exit at
    its 2nd boundary).  Launch counters are zeroed just before the
    sequences are submitted and read just after the last one finished.
    Returns a dict: the streams, the serving and scheduler reports, the
    launches, the LM's weights, the seconds to build the weights on the
    host and to upload them, the peak device memory in GB, and with
    ``trace`` the device time by kernel name from ``torch.profiler`` over
    the serving window.  ``tracer`` and ``metrics`` (``repro_torch.obs``)
    go to the Client."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.kernels.attn_lm import kernel as AK
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.serving.attention import AttentionParams, build_weights

    p = AttentionParams(
        d_model=SERVING["d_model"], vocab=SERVING["vocab_size"],
        n_heads=SERVING["attn_heads"], kv_heads=SERVING["attn_kv_heads"],
        head_dim=SERVING["attn_head_dim"],
        block_size=SERVING["kv_block_size"], max_ctx=SERVING["max_ctx"],
        seed=SERVING["weights_seed"])
    t0 = time.perf_counter()
    build_weights(p)          # cached: the serving LM uploads this array
    build_s = time.perf_counter() - t0
    lock = threading.Lock()
    rounds, chunks, fired = [], {}, set()

    def on_chunk(region, task):
        if task.phase != "decode":
            return
        with lock:
            if task.tid not in chunks:
                rounds.append(task.tid)
                chunks[task.tid] = 0
            chunks[task.tid] += 1
            nth = rounds.index(task.tid) + 1
            if (nth % PREEMPT_EVERY == 1 and chunks[task.tid] == 2
                    and task.tid not in fired):
                fired.add(task.tid)
                region.request_preempt()

    def on_launch(region, task):
        if task.phase != "decode":
            return
        with lock:
            if task.tid not in chunks:
                rounds.append(task.tid)
                chunks[task.tid] = 0
            nth = rounds.index(task.tid) + 1
            if nth % PREEMPT_EVERY == 1 and task.tid not in fired:
                fired.add(task.tid)
                region.flag.write(2)

    torch.cuda.reset_peak_memory_stats()
    client = repro_torch.Client(n_regions=2, chunk_budget=SERVE_CHUNK_BUDGET,
                                serving=SERVING, tracer=tracer,
                                metrics=metrics, engine=engine)
    try:
        for r in client.shell.regions:
            r.on_chunk = on_chunk
            r.on_launch = on_launch
        t0 = time.perf_counter()
        lm = client.serving.lm           # uploads the weights once
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        prof = (profile(activities=[ProfilerActivity.CUDA]) if trace
                else contextlib.nullcontext())
        FK.LAUNCHES.reset()
        DK.LAUNCHES.reset()
        AK.MEGA_LAUNCHES.reset()
        AK.STEPS.reset()
        with prof:
            handles = [client.stream(prompt, max_new_tokens=new)
                       for prompt, new in traffic]
            streams = [h.result(timeout=TIMEOUT_S) for h in handles]
            torch.cuda.synchronize()
        launches = {"flash_attention": FK.LAUNCHES.total(),
                    "decode_attention": DK.LAUNCHES.total()}
        if engine == "megakernel":
            launches.update({
                "attn_prefill_mega": AK.MEGA_LAUNCHES["AttnPrefill"],
                "attn_decode_mega": AK.MEGA_LAUNCHES["AttnDecode"],
                "segments": AK.STEPS["AttnPrefill"],
                "steps": AK.STEPS["AttnDecode"]})
        run = {"streams": streams, "launches": launches,
               "weights": lm.weights, "build_s": build_s,
               "upload_s": upload_s, "serving": client.serving_report(),
               "scheduler": client.report(),
               "by_kernel": ({e.key: e.self_device_time_total / 1e3
                              for e in prof.key_averages()
                              if e.self_device_time_total > 0}
                             if trace else None)}
    finally:
        client.shutdown()
    run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return run


def log_serving(tag: str, run: dict, want_launches=None):
    srep, rep, weights = run["serving"], run["scheduler"], run["weights"]
    log(f"[{tag}] {srep['n_finished']}/{N_SEQS} sequences, "
        f"{srep['tokens_out']} tokens in {srep['wall_s']:.3f} s: "
        f"{srep['tokens_per_s']:.3f} tokens/s; TTFT p50 "
        f"{srep['ttft_p50_s'] * 1e3:.3f} ms, p99 "
        f"{srep['ttft_p99_s'] * 1e3:.3f} ms; prefill tasks "
        f"{srep['prefill_tasks']}, decode rounds {srep['decode_rounds']}, "
        f"decode preemptions {srep['decode_preemptions']}, scheduler "
        f"preemptions {rep['preemptions']}, host spills avoided "
        f"{rep['host_spills_avoided']}")
    log(f"[{tag}] weights {tuple(weights.shape)} f32 "
        f"({weights.numel() * 4 / 1e9:.3f} GB): host build "
        f"{run['build_s']:.3f} s (cached after the first pass), upload "
        f"{run['upload_s']:.3f} s; peak device memory {run['peak_gb']:.3f} "
        f"GB; kv {srep['kv']}")
    log(f"[{tag}] launches {run['launches']} (expected "
        f"{want_launches or 'as the first pass'}); kernel_mode "
        f"{[r['kernel_mode'] for r in rep['reconfig']['regions'].values()]}")


def check_serving_trace(run: dict, tracer, reg):
    """The traced, metered serving pass: the tokens counter equals the
    tokens streamed, the TTFT histogram counts one per sequence, and the
    ``decode_round`` spans number the engine's rounds."""
    srep = run["serving"]
    n_tokens = sum(len(s) for s in run["streams"])
    tokens = sum(inst.value for kind, name, _l, inst in reg.series()
                 if name == "serving_tokens_total")
    ttft = sum(inst.n for kind, name, _l, inst in reg.series()
               if name == "serving_ttft_seconds")
    evs = tracer.events()
    rounds = sum(e.kind == "decode_round" for e in evs)
    t = srep["trace"]
    log(f"[serve, flight recorder] serving_tokens_total {tokens:g} (tokens "
        f"streamed {n_tokens}), serving_ttft_seconds count {ttft} "
        f"({N_SEQS} sequences), decode_round spans {rounds} (engine rounds "
        f"{srep['decode_rounds']}); {tracer.n_emitted} events, dropped "
        f"{tracer.dropped}; per_task n_tasks {t['per_task']['n_tasks']}, "
        f"preempt_response {t['preempt_response']}; region occupancy "
        f"{ {k: round(v['occupancy'], 4) for k, v in t['regions'].items()} }")
    if (tokens != n_tokens or ttft != N_SEQS
            or rounds != srep["decode_rounds"] or tracer.dropped
            or not t["enabled"] or not srep["telemetry"]["enabled"]):
        raise AssertionError(
            f"[serve, flight recorder] tokens {tokens} / {n_tokens}, ttft "
            f"{ttft} / {N_SEQS}, decode_round spans {rounds} / "
            f"{srep['decode_rounds']}, dropped {tracer.dropped}")


# -- [serve, mega]: M4/M5, the attention LM's persistent kernels -------------

def _attn_buffers(kind: str, dev, rng, weights, p, steps: int = None,
                  lens=None):
    """One attention-LM task's buffers on the card, twice (M4/M5's and the
    plain version's; the weights shared), and its scalars, at the serving
    shapes: for ``prefill`` ``prefill_batch`` rows of seeded prompts of
    ``ATTN_PROMPT_LENS`` tokens (or of the lengths ``lens``); for
    ``decode`` ``max_slots`` rows of a
    ``round_tokens``-step round (or ``steps``) over shuffled pages of
    random pools, row 0 live all round, the others live, dead (inactive)
    or short (fewer tokens than the round, 0 included) at random."""
    import numpy as np
    import torch

    from repro_torch.serving import attention as A

    if kind == "prefill":
        PB, P = SERVING["prefill_batch"], p.max_ctx
        prompt = np.zeros((PB, P), np.int32)
        meta = np.zeros((PB, A.META_W), np.int32)
        for r in range(PB):
            n = lens[r] if lens else int(rng.integers(ATTN_PROMPT_LENS[0],
                                                      ATTN_PROMPT_LENS[1] + 1))
            prompt[r, :n] = rng.integers(0, p.vocab, n)
            meta[r, 0] = n
        kv = np.zeros((PB, P, p.kv_heads, p.head_dim), np.float32)
        bufs = (np.full((PB, A.PREFILL_OUT_W), -1, np.int32), kv, kv.copy(),
                prompt, meta)
        scalars = dict(PB=PB, P=P, vocab=p.vocab)
    else:
        S, R = SERVING["max_slots"], steps or SERVING["round_tokens"]
        T_blk = p.blocks_per_seq
        NB = S * T_blk + 1
        shape = (NB, p.block_size, p.kv_heads, p.head_dim)
        k_pool = rng.standard_normal(shape, dtype=np.float32)
        v_pool = rng.standard_normal(shape, dtype=np.float32)
        k_pool[0] = v_pool[0] = 0.0
        table = np.zeros((S, p.table_width), np.int32)
        pages = rng.permutation(np.arange(1, NB))
        for s in range(S):
            pos = int(rng.integers(1, max(2, p.max_ctx - R)))
            table[s, 0] = 1 if s == 0 else int(rng.integers(0, 2))
            table[s, 1] = R if s == 0 else int(rng.integers(0, R + 1))
            table[s, 2] = int(rng.integers(0, p.vocab))
            table[s, A.COL_SEQ_LEN] = pos
            n_blk = min(T_blk, -(-(pos + R) // p.block_size))
            table[s, A.TABLE_META:A.TABLE_META + n_blk] = pages[
                s * T_blk:s * T_blk + n_blk]
        bufs = (np.full((S, R), -1, np.int32), k_pool, v_pool, table)
        scalars = dict(S=S, R=R, vocab=p.vocab)
    mine = tuple(torch.tensor(b, device=dev) for b in bufs) + (weights,)
    plain = tuple(b.clone() for b in mine[:-1]) + (weights,)
    return mine, plain, scalars


def _attn_launch(kind: str, words, bufs, p, budget: int, flag):
    from repro_torch.kernels.attn_lm import kernel as AK

    if kind == "prefill":
        return AK.attn_prefill_mega(words, *bufs[:6], p.geometry(),
                                    budget, flag)
    return AK.attn_decode_mega(words, *bufs[:5], p.geometry(), budget,
                               flag)


def _attn_step(kind: str, mine, plain, scalars, p, ctx, budget: int, flag,
               boundary: int):
    """One launch of M4/M5 and of its plain version (the host loop over the
    task's chunk body, on the card: cuBLAS products, B2/B3) from ``ctx``
    with the flag at ``boundary``: equal context words, chunk counts and
    progress, tokens and tables bitwise, K/V within 2e-5.  Returns (the
    context after it, the K/V's max abs difference)."""
    import numpy as np
    import torch

    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.preemption import make_megakernel
    from repro_torch.serving import attention as A

    names = A.register_attention_kernels(p)
    kd = get_kernel(names[0] if kind == "prefill" else names[1])
    flag.write(boundary)
    words, n = _attn_launch(kind, ctx.to_words(), mine, p, budget,
                            flag).result()
    progress = flag.progress()
    _, ints, floats = kd.bundle(*plain, **scalars).padded()
    want, _, want_n = make_megakernel(kd)(ctx, plain, ints, floats, budget,
                                          flag).result()
    torch.cuda.synchronize()
    err, same = 0.0, True
    for a, b in zip(mine[:-1], plain[:-1]):
        if a.dtype == torch.int32:
            same = same and torch.equal(a, b)
        else:
            err = max(err, float((a - b).abs().max()))
    if (n != want_n or progress != n or not same or not err <= F32_TOL
            or not np.array_equal(words, want.to_words())):
        raise AssertionError(
            f"[serve, mega] {kind} at boundary {boundary}, budget {budget}: "
            f"chunks {n} / {want_n}, progress {progress}, tokens and tables "
            f"equal {same}, K/V differ by {err}, context words equal "
            f"{np.array_equal(words, want.to_words())}")
    flag.clear()
    return want, err


def _emitted_gap(kind: str, plain, table0, p) -> float:
    """The smallest gap between the top two logits of a token the task
    emitted, recomputed in plain torch from the plain version's finished
    buffers (``table0``: the decode table before the round): a query row
    a prefill row's last prompt position or a live decode step, attending
    its own keys."""
    import torch

    from repro_torch.serving import attention as A

    E, pe, wq, _, _, wo = A._split(plain[-1], p)
    H, KV, hd = p.n_heads, p.kv_heads, p.head_dim
    if kind == "prefill":
        _, k_new, v_new, prompt, meta = plain[:5]
        rows = (meta[:, 0] > 0).nonzero()[:, 0]
        n = meta[rows, 0].long()
        x = E[prompt[rows, n - 1]] + pe[n - 1]
        keys, vals = k_new[rows], v_new[rows]
    else:
        out, k_pool, v_pool = plain[:3]
        xs, ks, vs, ns = [], [], [], []
        for s_ in range(table0.shape[0]):
            if table0[s_, 0] != 1:
                continue
            pages = table0[s_, A.TABLE_META:].long()
            for t in range(int(table0[s_, 1])):
                tok = table0[s_, 2] if t == 0 else out[s_, t - 1]
                pos = min(int(table0[s_, A.COL_SEQ_LEN]) + t, p.max_ctx - 1)
                xs.append(E[tok] + pe[pos])
                ks.append(k_pool[pages].reshape(-1, KV, hd))
                vs.append(v_pool[pages].reshape(-1, KV, hd))
                ns.append(pos + 1)
        if not xs:
            return math.inf
        x, keys, vals = torch.stack(xs), torch.stack(ks), torch.stack(vs)
        n = torch.tensor(ns, device=x.device)
    if not len(n):
        return math.inf
    q = (x @ wq.T).view(-1, H, hd)
    k, v = (t.repeat_interleave(H // KV, dim=2) for t in (keys, vals))
    s_ = torch.einsum("nhd,nlhd->nhl", q, k) / hd ** 0.5
    past = (torch.arange(k.shape[1], device=x.device)[None, None, :]
            >= n[:, None, None])
    a = s_.masked_fill(past, -math.inf).softmax(-1)
    o = torch.einsum("nhl,nlhd->nhd", a, v).reshape(-1, H * hd)
    top = ((o @ wo) @ E.T).topk(2).values
    return float((top[:, 0] - top[:, 1]).min())


def _attn_checks(dev, rng, weights, p) -> dict:
    """M4/M5 against their plain versions at the serving widths and shapes:
    the flag at every boundary of one task each (the flag at boundary k of
    a fresh task, then at k for every resume) at ``ATTN_BUDGETS`` (M4 also
    with ``ATTN_EMIT_LENS``' prompts at the main path's budget), then
    random boundaries of ``ATTN_RANDOM_TASKS`` tasks at budget 1.  Returns
    the launches compared, the largest K/V difference and the smallest
    top-two gap of the plain logits among the emitted tokens, per kernel."""
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import PreemptFlag

    flag = PreemptFlag(dev)
    out = {}
    for kind in ("prefill", "decode"):
        steps = (p.max_ctx // p.block_size if kind == "prefill"
                 else SERVING["round_tokens"])
        n_launch, err, gap = 0, 0.0, math.inf
        for budget in ATTN_BUDGETS:
            for k in range(0, -(-steps // budget) + 1):
                mine, plain, sc = _attn_buffers(kind, dev, rng, weights, p)
                ctx, table0 = ContextRecord.fresh(), plain[3].clone()
                while not ctx.done:
                    ctx, e = _attn_step(kind, mine, plain, sc, p, ctx,
                                        budget, flag, k)
                    n_launch, err = n_launch + 1, max(err, e)
                gap = min(gap, _emitted_gap(kind, plain, table0, p))
        for lens in ATTN_EMIT_LENS if kind == "prefill" else ():
            budget = SERVE_CHUNK_BUDGET
            for k in range(0, -(-steps // budget) + 1):
                mine, plain, sc = _attn_buffers(kind, dev, rng, weights, p,
                                                lens=lens)
                ctx = ContextRecord.fresh()
                while not ctx.done:
                    ctx, e = _attn_step(kind, mine, plain, sc, p, ctx,
                                        budget, flag, k)
                    n_launch, err = n_launch + 1, max(err, e)
                if not bool((mine[0][:, 0] >= 0).all()):
                    raise AssertionError(f"[serve, mega] prompts {lens}: a "
                                         f"row emitted no token")
        small = n_launch
        for _ in range(ATTN_RANDOM_TASKS):
            mine, plain, sc = _attn_buffers(kind, dev, rng, weights, p)
            ctx, table0 = ContextRecord.fresh(), plain[3].clone()
            while not ctx.done:
                ctx, e = _attn_step(kind, mine, plain, sc, p, ctx, 1, flag,
                                    int(rng.integers(1, steps + 1)))
                n_launch, err = n_launch + 1, max(err, e)
            gap = min(gap, _emitted_gap(kind, plain, table0, p))
        m = "M4" if kind == "prefill" else "M5"
        log(f"[serve, mega] {m} ({kind}) equals its plain version at "
            f"d_model {p.d_model}, vocab {p.vocab}, {p.n_heads} heads, "
            f"{p.kv_heads} KV heads, hd {p.head_dim}: {small} launches at "
            f"every boundary of a {steps}-step task (budgets {ATTN_BUDGETS}"
            f"{'; prompts ' + str(ATTN_EMIT_LENS) if kind == 'prefill' else ''}), "
            f"{n_launch - small} at random boundaries of {ATTN_RANDOM_TASKS} "
            f"tasks; tokens, tables and context words bitwise, K/V max abs "
            f"difference {err:.3e} (tolerance {F32_TOL:g}); smallest top-two "
            f"gap of the plain logits among the emitted tokens (recomputed in "
            f"plain torch) {gap:.6g}")
        out[kind] = {"launches": n_launch, "err": err, "gap": gap}
    return out


def _attn_bounds(kind: str, mine, p, budget: int) -> tuple:
    """(bytes ms, operations ms) of one whole task at its inputs, run in
    chunks of ``budget``.  M4: a chunk's outputs must be whole when the
    flag is read at its end, and no work past that boundary may be asked
    for, so no pass over a weight serves two chunks; within a chunk the
    segments' x come from the prompt alone and their readouts can wait to
    the chunk's end, so a chunk reads Wq/Wk/Wv once and, when a row emits
    in it, Wo and E once.  M5: a step's x is the token the step before
    emitted, so every step reads Wq/Wk/Wv and, when a row is live, Wo and
    E, and its live rows' K/V (E alone is 50 times the L2).  Every segment
    or step does its products and its attention."""
    f32 = 4
    D, HQ, KVD = p.d_model, p.n_heads * p.head_dim, p.kv_heads * p.head_dim
    qkv_b, emit_b = (HQ + 2 * KVD) * D * f32, (HQ + p.vocab) * D * f32
    bytes_, ops = 0.0, 0.0
    if kind == "prefill":
        C = p.block_size
        plen = mine[4][:, 0].tolist()
        PB, n_seg = len(plen), p.max_ctx // C
        for c0 in range(0, n_seg, budget):
            seg = range(c0 * C, min(n_seg, c0 + budget) * C)
            n_emit = sum(n - 1 in seg for n in plen)
            bytes_ += qkv_b + (emit_b if n_emit else 0)
            bytes_ += 2 * PB * len(seg) * KVD * f32   # k_new, v_new written
            pairs = sum(i + 1 for i in seg)
            ops += (2 * PB * len(seg) * D * (HQ + 2 * KVD)
                    + 4 * PB * p.n_heads * pairs * p.head_dim
                    + 2 * n_emit * (HQ * D + D * p.vocab))
    else:
        table = mine[3].cpu()
        S, R = mine[0].shape
        for t in range(R):
            live = [s for s in range(S)
                    if table[s, 0] == 1 and t < table[s, 1]]
            keys = sum(min(int(table[s, 3]) + t, p.max_ctx - 1) + 1
                       for s in live)
            bytes_ += qkv_b + (emit_b if live else 0)
            bytes_ += 2 * keys * KVD * f32
            ops += (2 * S * D * (HQ + 2 * KVD) + 4 * p.n_heads * keys
                    * p.head_dim + 2 * len(live) * (HQ * D + D * p.vocab))
    return bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def _attn_times(dev, rng, weights, p, launches: dict, checked: dict) -> list:
    """M4/M5's device time a launch and a chunk at the main path's shapes
    and budget (a prefill of ``prefill_batch`` rows, 8 segments; a round of
    ``max_slots`` slots x ``round_tokens`` steps), the plain version's (the
    host loop's cuBLAS products and B2/B3), the bound, the grid; then the
    host time from a flag write to a running M5 launch's exit."""
    import torch

    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import PreemptFlag, make_megakernel
    from repro_torch.kernels.attn_lm import kernel as AK
    from repro_torch.serving import attention as A

    flag = PreemptFlag(dev)
    fresh = ContextRecord.fresh()
    budget = SERVE_CHUNK_BUDGET
    names = A.register_attention_kernels(p)
    records = []
    for kind, name, kname in (("prefill", "attn_prefill_mega", names[0]),
                              ("decode", "attn_decode_mega", names[1])):
        mine, plain, sc = _attn_buffers(kind, dev, rng, weights, p)
        saved = [b.clone() for b in mine[:-1]]
        kd = get_kernel(kname)
        _, ints, floats = kd.bundle(*plain, **sc).padded()
        entry = make_megakernel(kd)
        steps = (p.max_ctx // p.block_size if kind == "prefill"
                 else SERVING["round_tokens"])
        chunks = -(-steps // budget)

        def mega(kind=kind, mine=mine):
            _attn_launch(kind, fresh.to_words(), mine, p, budget, flag)

        def host_loop(entry=entry, plain=plain, ints=ints, floats=floats):
            entry(fresh, plain, ints, floats, budget, flag)

        dev_ms, hows = {}, {}
        for arm, fn, key in (("kernel", mega, "attn_mega_kernel"),
                             ("plain", host_loop, None)):
            dev_ms[arm] = _named_ms(fn, key, 1) if key else device_ms(fn)
            hows[arm] = "torch.profiler"
            if dev_ms[arm] <= 0.0:
                dev_ms[arm] = queued_ms(fn, reps=5)
                hows[arm] = "queued behind a spin kernel"
        for a, b in zip(mine[:-1], saved):  # the bound counts the inputs
            a.copy_(b)
        bytes_ms, ops_ms = _attn_bounds(kind, mine, p, budget)
        grid = AK.grid(kind == "decode", p.geometry(),
                       SERVING["max_slots"], dev)
        m = "M4" if kind == "prefill" else "M5"
        log(f"[serve, mega] {name} ({m}), budget {budget} ({chunks} chunks "
            f"of {budget} {'segments' if kind == 'prefill' else 'steps'}): "
            f"{dev_ms['kernel']:.6f} ms device a launch ({hows['kernel']}), "
            f"{dev_ms['kernel'] / chunks:.6f} ms a chunk, "
            f"{dev_ms['kernel'] / steps:.6f} ms a "
            f"{'segment' if kind == 'prefill' else 'step'}; the plain "
            f"version (host loop: cuBLAS f32 products, B2/B3) "
            f"{dev_ms['plain']:.6f} ms device a task ({hows['plain']}); bound "
            f"{max(bytes_ms, ops_ms):.6f} ms (bytes {bytes_ms:.6f}, "
            f"operations {ops_ms:.6f}); grid {grid[0]} blocks (cap "
            f"{grid[1]}, {grid[2]} co-resident)")
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/attn_lm.cu",
            "replaces": REPLACES_MEGA,
            "counterpart_of": f"make_megakernel (a lax.while_loop over "
                              f"attn_{kind}, src/repro/serving/attention.py, "
                              f"not a pallas_call)",
            "launches": launches[name], "max_abs_err": checked[kind]["err"],
            "ms": dev_ms["kernel"], "per": f"launch of {chunks} chunks",
            "ms_per_chunk": dev_ms["kernel"] / chunks,
            "plain_ms": dev_ms["plain"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "grid": list(grid)})

    # a flag write landing in a running M5 launch: the host spins on the
    # launch's event, so the time is the card's answer, not a poll sleep
    mine, _, _ = _attn_buffers("decode", dev, rng, weights, p,
                               steps=ATTN_LAG_STEPS)
    mine[3][:, 0] = 1                      # every row live all along
    mine[3][:, 1] = ATTN_LAG_STEPS
    lags = []
    for _ in range(ATTN_LAG_TRIALS):
        launch = _attn_launch("decode", fresh.to_words(), mine, p, 1, flag)
        if not _wait(lambda: flag.progress() >= ATTN_LAG_AT, timeout=60):
            raise AssertionError("[serve, mega] the lag launch never "
                                 "progressed")
        flag.write(1)
        t_w = time.perf_counter()
        at = flag.progress()
        while not launch.query():
            pass
        t_x = time.perf_counter()
        _, n = launch.result()
        flag.clear()
        lags.append(((t_x - t_w) * 1e6, n - at))
        if not 0 <= n - at <= 2 or n >= ATTN_LAG_STEPS:
            raise AssertionError(f"[serve, mega] the flag exit came {n - at} "
                                 f"chunks after the write ({n} run)")
    log(f"[serve, mega] a flag write into a running M5 launch "
        f"({SERVING['max_slots']} slots, budget 1): host write -> the "
        f"launch's event seen {[round(t, 3) for t, _ in lags]} us, chunks "
        f"after the device's published progress {[c for _, c in lags]}")
    records[-1]["flag_to_exit_us"] = [t for t, _ in lags]
    return records


def serve_mega_phase(dev, traffic, piped: dict, wants: list, p) -> list:
    """[serve, mega]: phase 8's traffic through ``Client(n_regions=2,
    serving=SERVING, engine="megakernel")`` once, every 3rd decode round
    armed through ``on_launch`` to exit at its 2nd boundary: every stream
    equal to ``attention_oracle_stream`` (``wants``, phase 8's replay), a
    round exited on the flag, one M4 launch a prefill and one M5 launch a
    decode dispatch, no B2/B3 launch between the first submit and the last
    result; tokens/s and TTFT beside phase 8's pipelined run (``piped``).
    Then M4/M5 against their plain versions and their times (phase 8's
    weights).  Returns the two kernel records."""
    import numpy as np

    run = serve_attention(traffic, engine="megakernel")
    srep, rep, launches = run["serving"], run["scheduler"], run["launches"]
    log_serving("serve, mega", run)
    dispatches = rep["megakernel_launches"]
    rounds = srep["decode_rounds"]
    want_m5 = (rounds, rounds + srep["decode_preemptions"])
    log(f"[serve, mega] M4 launches {launches['attn_prefill_mega']} (prefill "
        f"tasks {srep['prefill_tasks']}), M5 launches "
        f"{launches['attn_decode_mega']} (decode rounds {rounds}, each "
        f"preempted one launched again: {srep['decode_preemptions']}), "
        f"region launches {dispatches}, flag_poll_exits "
        f"{rep['flag_poll_exits']}; segments {launches['segments']}, steps "
        f"{launches['steps']}; B2 {launches['flash_attention']}, B3 "
        f"{launches['decode_attention']}")
    log(f"[serve, mega] megakernel: {srep['tokens_per_s']:.3f} tokens/s, TTFT "
        f"p50 {srep['ttft_p50_s'] * 1e3:.3f} ms, p99 "
        f"{srep['ttft_p99_s'] * 1e3:.3f} ms; pipelined (phase 8, first "
        f"pass): {piped['tokens_per_s']:.3f} tokens/s, TTFT p50 "
        f"{piped['ttft_p50_s'] * 1e3:.3f} ms, p99 "
        f"{piped['ttft_p99_s'] * 1e3:.3f} ms")
    if srep["n_finished"] != N_SEQS or srep["stranded_sequences"]:
        raise AssertionError(f"[serve, mega] finished {srep['n_finished']} "
                             f"of {N_SEQS}")
    if srep["decode_preemptions"] < 1 or rep["flag_poll_exits"] < 1:
        raise AssertionError("[serve, mega] no round exited on the flag")
    if (launches["attn_prefill_mega"] != srep["prefill_tasks"]
            or not want_m5[0] <= launches["attn_decode_mega"] <= want_m5[1]
            or launches["attn_prefill_mega"] + launches["attn_decode_mega"]
            != dispatches
            or launches["flash_attention"] or launches["decode_attention"]):
        raise AssertionError(f"[serve, mega] launches {launches}, expected "
                             f"{srep['prefill_tasks']} M4, {want_m5[0]} to "
                             f"{want_m5[1]} M5, {dispatches} in all (one a "
                             f"dispatch), no B2/B3")
    for i, (got, want) in enumerate(zip(run["streams"], wants)):
        if got != want:
            raise AssertionError(f"[serve, mega] sequence {i}: {got} != "
                                 f"oracle {want}")
    log(f"[serve, mega] all {N_SEQS} streams equal attention_oracle_stream "
        f"token for token")
    weights = run["weights"]
    del run
    rng = np.random.default_rng(25)
    checked = _attn_checks(dev, rng, weights, p)
    return _attn_times(dev, rng, weights, p, launches, checked)


def attention_phases(dev, card: str) -> list:
    """Phases 6-9, with [serve, mega] after phase 8's first pass; returns
    the kernel records of B2, B3, M4 and M5."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.decode_attention import ref as DR
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serving.attention import (AttentionParams,
                                               attention_oracle_stream)

    rng = np.random.default_rng(1)
    H, KV, hd, BS = (SERVING["attn_heads"], SERVING["attn_kv_heads"],
                     SERVING["attn_head_dim"], SERVING["kv_block_size"])
    PB, C, S = SERVING["prefill_batch"], BS, SERVING["max_ctx"]
    scale = 1.0 / hd ** 0.5

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=dev)

    def flash_case(what, qe, ke, ve, off, win, tol, f32, causal=True):
        """Max abs error of one launch against the plain version; raises
        past ``tol``.  Returns 0 for bf16: the record keeps f32's."""
        sc = 1.0 / qe.shape[-1] ** 0.5
        got = FK.launch(qe, ke, ve, causal=causal, window=win, q_offset=off,
                        scale=sc)
        torch.cuda.synchronize()
        want = FR.flash_attention(qe, ke, ve, causal=causal, window=win,
                                  q_offset=off, scale=sc)
        err = float((got.float() - want.float()).abs().max())
        plan = FK.plan(qe.shape[0], qe.shape[1], ke.shape[1], qe.shape[2],
                       ke.shape[2], qe.shape[3])
        log(f"[flash] {what} ({plan}): max_abs_err {err:.3e} (tolerance "
            f"{tol:g})")
        if not err <= tol:
            raise AssertionError(f"flash {what}: max_abs_err {err}")
        return err if f32 else 0.0

    # 6. flash check, with q and the cache laid out as the prefill has them
    q = randn(PB, C, H, hd).transpose(1, 2)
    k_new, v_new = randn(PB, S, KV, hd), randn(PB, S, KV, hd)
    k, v = k_new.transpose(1, 2), v_new.transpose(1, 2)
    flash_err = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name, f32 = str(dtype)[6:], dtype == torch.float32
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        for off in FLASH_OFFSETS:
            flash_err = max(flash_err, flash_case(
                f"{name} q_offset {off}", qd, kd, vd, off, None, tol, f32))
        for B_, H_, KV_, T_, S_, hd_, off, win in FLASH_EDGES:
            qe = randn(B_, H_, T_, hd_).to(dtype)
            ke, ve = (randn(B_, KV_, S_, hd_).to(dtype) for _ in range(2))
            flash_err = max(flash_err, flash_case(
                f"{name} B {B_} H {H_} KV {KV_} T {T_} S {S_} hd {hd_} "
                f"q_offset {off} window {win}", qe, ke, ve, off, win, tol,
                f32))
        for B_, H_, KV_, T_, S_, hd_, off, win in FLASH_NON_CAUSAL:
            qe = randn(B_, H_, T_, hd_).to(dtype)
            ke, ve = (randn(B_, KV_, S_, hd_).to(dtype) for _ in range(2))
            flash_err = max(flash_err, flash_case(
                f"{name} non-causal B {B_} H {H_} KV {KV_} T {T_} S {S_} hd "
                f"{hd_} q_offset {off} window {win}", qe, ke, ve, off, win,
                tol, f32, causal=False))
        q_store = randn(PB * C * H * hd + 1).to(dtype)
        kv_store = randn(2, PB * S * KV * hd + 1).to(dtype)
        qu = q_store[1:].view(PB, C, H, hd).transpose(1, 2)
        ku, vu = (kv_store[i, 1:].view(PB, S, KV, hd).transpose(1, 2)
                  for i in range(2))
        for off in FLASH_OFFSETS:
            flash_err = max(flash_err, flash_case(
                f"{name} unaligned serving layout q_offset {off}", qu, ku, vu,
                off, None, tol, f32))
        dead = FK.launch(qu, ku, vu, causal=True, window=0, q_offset=64,
                         scale=scale)
        torch.cuda.synchronize()
        if not bool((dead == 0).all()):
            raise AssertionError(f"flash {name} window 0: a row is not 0")
        log(f"[flash] {name} window 0: every row exactly 0")

    # 7. decode check
    B, T_blk = SERVING["max_slots"], SERVING["max_ctx"] // BS
    NB = B * T_blk + 1
    k_pool, v_pool = randn(NB, BS, KV, hd), randn(NB, BS, KV, hd)
    tables = torch.tensor(rng.permutation(np.arange(1, NB)).reshape(
        B, T_blk).astype(np.int32), device=dev)
    qs = randn(B, H, 1, hd)
    pos = torch.tensor([0, 1, 17, 40, 64, 100, 127, 128], dtype=torch.int32,
                       device=dev)
    got = DK.launch_paged(qs, k_pool, v_pool, tables, pos, window=None,
                          scale=scale)
    torch.cuda.synchronize()
    want = DR.paged_decode_attention(qs, k_pool, v_pool, tables, pos,
                                     scale=scale)
    decode_err = float((got - want).abs().max())
    log(f"[decode] paged, pos {pos.tolist()}: max_abs_err {decode_err:.3e} "
        f"(tolerance {F32_TOL:g}); pos-0 row all zero: "
        f"{bool((got[0] == 0).all())}")
    if not (decode_err <= F32_TOL and bool((got[0] == 0).all())):
        raise AssertionError(f"paged decode: max_abs_err {decode_err}")
    k_lin = DR.gather_kv_pages(k_pool, tables)
    v_lin = DR.gather_kv_pages(v_pool, tables)
    ring = torch.tensor([0, 5, 128, 129, 200, 255, 256, 1000],
                        dtype=torch.int32, device=dev)
    got = DK.launch(qs, k_lin, v_lin, ring, window=None, scale=scale)
    want = DR.decode_attention(qs, k_lin, v_lin, ring, scale=scale)
    ring_err = float((got - want).abs().max())
    log(f"[decode] contiguous ring, pos {ring.tolist()}: max_abs_err "
        f"{ring_err:.3e}")
    if not ring_err <= F32_TOL:
        raise AssertionError(f"ring decode: max_abs_err {ring_err}")
    decode_err = max(decode_err, ring_err)
    paged = DK.launch_paged(qs, k_pool, v_pool, tables, pos, window=None,
                            scale=scale)
    dense = DK.launch(qs, k_lin, v_lin, pos, window=None, scale=scale)
    torch.cuda.synchronize()
    if not torch.equal(paged, dense):
        raise AssertionError("paged decode is not bitwise equal to "
                             "gather-plus-contiguous")
    log("[decode] paged == gather-plus-contiguous, bitwise")
    # the new design's edges: groups 1 / 4 / 8, hd 64 and 128, a window
    for (h_, kv_, hd_), win in itertools.product(DECODE_EDGES, (None, 5)):
        kp, vp = randn(NB, BS, kv_, hd_), randn(NB, BS, kv_, hd_)
        qe = randn(B, h_, 1, hd_)
        sc = 1.0 / hd_ ** 0.5
        got = DK.launch_paged(qe, kp, vp, tables, pos, window=win, scale=sc)
        kl, vl = DR.gather_kv_pages(kp, tables), DR.gather_kv_pages(vp, tables)
        dense = DK.launch(qe, kl, vl, pos, window=win, scale=sc)
        ring_got = DK.launch(qe, kl, vl, ring, window=win, scale=sc)
        torch.cuda.synchronize()
        err = max(float((got - DR.paged_decode_attention(
            qe, kp, vp, tables, pos, window=win, scale=sc)).abs().max()),
            float((ring_got - DR.decode_attention(
                qe, kl, vl, ring, window=win, scale=sc)).abs().max()))
        plan = DK.plan(B, h_, kv_, T_blk * BS, hd_, paged=True)
        log(f"[decode] H {h_} KV {kv_} hd {hd_} window {win} ({plan}): "
            f"max_abs_err {err:.3e} (paged and ring); paged == "
            f"gather-plus-contiguous: {torch.equal(got, dense)}; pos-0 row "
            f"zero: {bool((got[0] == 0).all())}")
        if not (err <= F32_TOL and torch.equal(got, dense)
                and bool((got[0] == 0).all())):
            raise AssertionError(f"decode H {h_} KV {kv_} hd {hd_} window "
                                 f"{win}: max_abs_err {err}")
        decode_err = max(decode_err, err)

    # 8. token serving at full width
    traffic = serving_traffic()
    run = serve_attention(traffic)
    srep, streams, launches = run["serving"], run["streams"], run["launches"]
    want_launches = {"flash_attention": S // C * srep["prefill_tasks"],
                     "decode_attention": SERVING["round_tokens"]
                     * srep["decode_rounds"]}
    log_serving("serve", run, want_launches)
    if srep["n_finished"] != N_SEQS or srep["stranded_sequences"]:
        raise AssertionError(f"serving finished {srep['n_finished']} of "
                             f"{N_SEQS}")
    if srep["decode_preemptions"] < 1:
        raise AssertionError("no decode round was preempted")
    if launches != want_launches:
        raise AssertionError(f"launches {launches} != {want_launches}")
    p = AttentionParams(
        d_model=SERVING["d_model"], vocab=SERVING["vocab_size"], n_heads=H,
        kv_heads=KV, head_dim=hd, block_size=BS, max_ctx=S,
        seed=SERVING["weights_seed"])
    t0 = time.perf_counter()
    wants = []
    for i, ((prompt, new), got) in enumerate(zip(traffic, streams)):
        want = attention_oracle_stream(
            prompt, new, p, max_slots=SERVING["max_slots"],
            round_tokens=SERVING["round_tokens"],
            prefill_batch=SERVING["prefill_batch"], weights=run["weights"])
        if got != want:
            raise AssertionError(f"sequence {i} (prompt {len(prompt)}, "
                                 f"{new} new): {got} != oracle {want}")
        wants.append(want)
    log(f"[serve] all {N_SEQS} streams equal attention_oracle_stream "
        f"token for token ({time.perf_counter() - t0:.3f} s to replay)")
    del run
    # [serve, mega]: the same traffic in megakernel mode through M4/M5
    t0 = time.perf_counter()
    mega_records = serve_mega_phase(dev, traffic, srep, wants, p)
    log(f"[serve, mega] {time.perf_counter() - t0:.3f} s")
    # the same traffic once more, warm (kernels loaded, cuBLAS initialised),
    # and once under torch.profiler: where the device time of serving goes
    warm = serve_attention(traffic)
    log_serving("serve, warm", warm)
    traced = serve_attention(traffic, trace=True)
    busy_ms = sum(traced["by_kernel"].values())
    wall_ms = traced["serving"]["wall_s"] * 1e3
    log(f"[serve, traced] wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} "
        f"ms (busy share {busy_ms / wall_ms:.4f}; kernels on two streams "
        f"may overlap); top kernels by device time:")
    for key, ms in sorted(traced["by_kernel"].items(),
                          key=lambda kv: -kv[1])[:10]:
        log(f"[serve, traced]   {ms:10.3f} ms  {key[:110]}")
    tracer, reg = Tracer(), MetricsRegistry()
    observed = serve_attention(traffic, tracer=tracer, metrics=reg)
    log_serving("serve, flight recorder", observed)
    if (warm["streams"] != streams or traced["streams"] != streams
            or observed["streams"] != streams):
        raise AssertionError("a later pass streamed other tokens")
    check_serving_trace(observed, tracer, reg)
    del warm, traced, observed

    # 9. times at the serving shapes
    records = []
    f32 = 4
    q_bytes = PB * H * C * hd * f32

    def flash_kernel():
        for off in range(0, S, C):
            FK.launch(q, k, v, causal=True, window=None, q_offset=off,
                      scale=scale)

    def flash_plain():
        for off in range(0, S, C):
            FR.flash_attention(q, k, v, causal=True, q_offset=off,
                               scale=scale)

    masks = [(torch.arange(S, device=dev)[None, :]
              <= off + torch.arange(C, device=dev)[:, None])
             for off in range(0, S, C)]

    def flash_library():
        for mask in masks:
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           scale=scale, enable_gqa=True)

    lib_err = float((F.scaled_dot_product_attention(
        q, k, v, attn_mask=masks[-1], scale=scale, enable_gqa=True)
        - FK.launch(q, k, v, causal=True, window=None, q_offset=S - C,
                    scale=scale)).abs().max())
    # bound per launch from what its data needs: q and o once, the K/V rows
    # up to the causal limit, 4 FLOP per (query, key, head-dim) pair kept
    bounds = []
    for off in range(0, S, C):
        keys = off + C
        nbytes = 2 * q_bytes + 2 * PB * KV * keys * hd * f32
        pairs = sum(off + i + 1 for i in range(C))
        flops = 4 * PB * H * pairs * hd
        bounds.append((nbytes / HBM_BYTES_PER_S * 1e3,
                       flops / F32_OPS_PER_S * 1e3))
    records.append(time_kernel(
        "flash_attention", S // C, flash_kernel, flash_plain, flash_library,
        bounds, launches["flash_attention"], flash_err,
        f"{lib_err:.3e} max diff vs kernel at q_offset {S - C}"))

    dense_mask = ((torch.arange(T_blk * BS, device=dev)[None, :]
                   < pos[:, None].long())[:, None, None, :])

    def decode_kernel():
        DK.launch_paged(qs, k_pool, v_pool, tables, pos, window=None,
                        scale=scale)

    def decode_plain():
        DR.paged_decode_attention(qs, k_pool, v_pool, tables, pos,
                                  scale=scale)

    def decode_library():
        F.scaled_dot_product_attention(qs, k_lin, v_lin, attn_mask=dense_mask,
                                       scale=scale, enable_gqa=True)

    live = pos > 0
    lib_err = float((F.scaled_dot_product_attention(
        qs, k_lin, v_lin, attn_mask=dense_mask, scale=scale,
        enable_gqa=True)[live] - paged[live]).abs().max())
    valid_keys = int(pos.clamp(max=T_blk * BS).sum())
    nbytes = (2 * B * H * hd * f32 + tables.numel() * 4 + B * 4
              + 2 * valid_keys * KV * hd * f32)
    flops = 4 * H * valid_keys * hd
    records.append(time_kernel(
        "decode_attention", 1, decode_kernel, decode_plain, decode_library,
        [(nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_OPS_PER_S * 1e3)],
        launches["decode_attention"], decode_err,
        f"{lib_err:.3e} max diff vs kernel on live rows (library on the "
        f"gathered dense cache)"))
    log(f"[time] attention bounds: {HBM_BYTES_PER_S / 1e12:g} TB/s, "
        f"{F32_OPS_PER_S / 1e12:g} TFLOP/s f32 (H100 SXM data sheet); card "
        f"{card}")
    return records + mega_records


def time_kernel(name, n_launch, kernel, plain, library, bounds, launches,
                err, lib_note) -> dict:
    """Device time (``torch.profiler``, else queued behind a spin kernel)
    and CUDA-event time per launch of ``kernel`` (``n_launch`` launches per
    call), its plain version and the library yardstick; the bound is the
    mean over the launches of the larger of the bytes and the FLOPs
    times."""
    fns = {"kernel": kernel, "plain": plain, "library": library}
    dev_ms = {"kernel": device_ms(kernel, launches=n_launch),
              "plain": device_ms(plain), "library": device_ms(library)}
    wall_ms = {"kernel": cuda_time_ms(kernel, reps=50),
               "plain": cuda_time_ms(plain, reps=10),
               "library": cuda_time_ms(library, reps=50)}
    for arm in dev_ms:
        if dev_ms[arm] <= 0.0:
            log(f"[time] {name} {arm}: the profiler missed the launches; "
                f"using the time queued behind a spin kernel")
            dev_ms[arm] = queued_ms(fns[arm])
        log(f"[time] {name} {arm}: device {dev_ms[arm] / n_launch:.6f} ms "
            f"per launch; wall (CUDA events, back-to-back) "
            f"{wall_ms[arm] / n_launch:.6f} ms per launch")
    bytes_ms = sum(b for b, _ in bounds) / len(bounds)
    ops_ms = sum(o for _, o in bounds) / len(bounds)
    bound_ms = sum(max(b, o) for b, o in bounds) / len(bounds)
    rec = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/csrc/{name}.cu",
           "replaces": REPLACES_ATTN[name], "launches": launches,
           "max_abs_err": err, "ms": dev_ms["kernel"] / n_launch,
           "plain_ms": dev_ms["plain"] / n_launch, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": dev_ms["library"] / n_launch}
    log(f"[time] {name}: kernel {rec['ms']:.6f} ms device per launch; bound "
        f"{bound_ms:.6f} ms (bytes {bytes_ms:.6f}, FLOPs {ops_ms:.6f}); "
        f"library {rec['library_ms']:.6f} ms ({lib_note})")
    return rec


def _scan_inputs(rng, dev, B, T, L):
    import numpy as np
    import torch

    a = torch.sigmoid(torch.tensor(rng.standard_normal((B, T, L),
                                                       dtype=np.float32),
                                   device=dev))
    b = torch.tensor(rng.standard_normal((B, T, L), dtype=np.float32),
                     device=dev)
    h0 = torch.tensor(rng.standard_normal((B, L), dtype=np.float32),
                      device=dev)
    return a, b, h0


def _rwkv_inputs(rng, dev, B, T, H, hd):
    import numpy as np
    import torch

    def randn(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32)
                            * scale, device=dev)

    # r, k, v as the projections leave them: [B, T, H*hd] viewed per head
    r, k, v = (randn(B, T, H * hd).view(B, T, H, hd) for _ in range(3))
    logw = -torch.exp(randn(B, T, H, hd, scale=0.5) - 1)
    return r, k, v, logw, randn(H, hd, scale=0.1), randn(B, H, hd, hd,
                                                          scale=0.5)


def recurrence_checks(dev) -> dict:
    """Phase 10: each recurrence kernel against its plain version; returns
    the largest error of each."""
    import numpy as np
    import torch

    from repro_torch.kernels.rglru_scan import kernel as GK
    from repro_torch.kernels.rglru_scan import ref as GR
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6 import ref as WR

    rng = np.random.default_rng(2)
    B, T, L = SERVE_LM["batch"], SERVE_LM["prompt_len"], 4096
    errs = {"rglru_scan": 0.0, "rwkv6": 0.0}
    for shape in SCAN_SHAPES + ((B, T, L), (B, 1, L)):
        a, b, h0 = _scan_inputs(rng, dev, *shape)
        for init in (h0, None):
            got = GK.launch(a, b, init)
            torch.cuda.synchronize()
            want = GR.rglru_scan(a, b, init)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            log(f"[rec] rglru_scan {list(shape)} h0 "
                f"{'random' if init is not None else 'None'}: max_abs_err "
                f"{err:.3e} (tolerance {SCAN_TOL:g})")
            if not err <= SCAN_TOL:
                raise AssertionError(f"rglru_scan {shape}: {err}")
            errs["rglru_scan"] = max(errs["rglru_scan"], err)
    for shape in RWKV_SHAPES + ((B, T, 32, 64), (B, 1, 32, 64)):
        r, k, v, logw, u, s0 = _rwkv_inputs(rng, dev, *shape)
        for init in (s0, None):
            got = WK.launch(r, k, v, logw, u, init)
            torch.cuda.synchronize()
            want = WR.rwkv6(r, k, v, logw, u, init)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            log(f"[rec] rwkv6 {list(shape)} s0 "
                f"{'random' if init is not None else 'None'}: max_abs_err "
                f"{err:.3e} (tolerance {RWKV_TOL:g})")
            if not err <= RWKV_TOL:
                raise AssertionError(f"rwkv6 {shape}: {err}")
            errs["rwkv6"] = max(errs["rwkv6"], err)
    return errs


def _numel(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numel(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _numel(v)
    else:
        yield tree.numel()


def _by_kernel(prof) -> dict:
    return {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0}


# the recurrence kernels' names as the profiler shows them (B4 has a
# one-step kernel for decode and a segmented one for longer T)
RECURRENCE_KERNEL = re.compile(r"(rglru_\w+_kernel|rwkv6_kernel)(<\w+>)?")


def _log_by_kernel(tag: str, by_kernel_counts: dict):
    by_kernel = {k: ms for k, (ms, _) in by_kernel_counts.items()}
    for k, (ms, n) in by_kernel_counts.items():
        found = RECURRENCE_KERNEL.search(k)
        if found:
            log(f"[{tag}] in the path: {found.group(0)} {n} launches, "
                f"{ms * 1e3 / n:.3f} us device per launch")
    total = sum(by_kernel.values())
    if total <= 0:
        log(f"[{tag}] the profiler saw no device time")
        return
    rec = sum(ms for k, ms in by_kernel.items() if RECURRENCE_KERNEL.search(k))
    gemm = sum(ms for k, ms in by_kernel.items()
               if any(w in k.lower() for w in ("gemm", "xmma", "cutlass")))
    log(f"[{tag}] device {total:.3f} ms: B4/B5 {rec:.3f} ms (share "
        f"{rec / total:.4f}), f32 GEMMs {gemm:.3f} ms (share "
        f"{gemm / total:.4f}); top kernels:")
    for key, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[{tag}]   {ms:10.3f} ms  {key[:110]}")


def serve_recurrent(arch: str, dev) -> dict:
    """Phase 11 for one model: the main path through ``serve``, then the
    plain replay and a warm kernel pass on the same weights and prompts,
    then one traced prefill and one traced decode step.  Returns the
    launches of the main path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.native import plain_versions
    from repro_torch.kernels.rglru_scan import kernel as GK
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.launch import serve as S
    from repro_torch.models.lm import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    kinds = cfg.layer_kinds
    want = {"rglru_scan": kinds.count("rglru") * SERVE_LM["gen"],
            "rwkv6": kinds.count("rwkv") * SERVE_LM["gen"]}
    log(f"[lm {arch}] {cfg.n_layers} layers, d_model {cfg.d_model}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    GK.LAUNCHES.reset()
    WK.LAUNCHES.reset()
    t0 = time.perf_counter()
    toks = S.serve(cfg, **SERVE_LM)          # cuda:0, the entry point
    serve_s = time.perf_counter() - t0
    launches = {"rglru_scan": GK.LAUNCHES.total(),
                "rwkv6": WK.LAUNCHES.total()}
    log(f"[lm {arch}] serve: {serve_s:.3f} s end to end (weights drawn on "
        f"the card included); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
        f"{launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches} != {want}")
    if toks.shape != (SERVE_LM["batch"], SERVE_LM["gen"]) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: bad tokens {toks.shape}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, prompts, _ = S.draw(cfg, batch=SERVE_LM["batch"],
                                prompt_len=SERVE_LM["prompt_len"],
                                seed=SERVE_LM["seed"], device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(_numel(params))
    with plain_versions():
        plain = S.generate(params, prompts, cfg, gen=SERVE_LM["gen"])
    if GK.LAUNCHES.total() != launches["rglru_scan"] or \
            WK.LAUNCHES.total() != launches["rwkv6"]:
        raise AssertionError("the plain replay launched a kernel")
    warm = S.generate(params, prompts, cfg, gen=SERVE_LM["gen"])
    logit_err = float((warm["logits"] - plain["logits"]).abs().max())
    n_dec = SERVE_LM["batch"] * (SERVE_LM["gen"] - 1)
    for tag, run in (("plain", plain), ("kernels, warm", warm)):
        log(f"[lm {arch}] {tag}: prefill {run['prefill_s']:.4f} s, decode "
            f"{n_dec / run['decode_s']:.3f} tokens/s "
            f"({run['decode_s']:.4f} s for {SERVE_LM['gen'] - 1} steps)")
    log(f"[lm {arch}] {n_params / 1e9:.3f} B parameters ({n_params * 4 / 1e9:.3f}"
        f" GB f32) drawn on the card in {draw_s:.3f} s; prefill logits "
        f"kernels vs plain max_abs_err {logit_err:.3e} (tolerance "
        f"{LOGIT_TOL:g}; max |logit| "
        f"{float(plain['logits'].abs().max()):.3f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log(f"[lm {arch}] tokens[0]: {toks[0].tolist()}")
    if not (np.array_equal(toks, plain["tokens"])
            and np.array_equal(toks, warm["tokens"])):
        raise AssertionError(f"{arch}: greedy tokens differ from the plain "
                             f"replay")
    if not logit_err <= LOGIT_TOL:
        raise AssertionError(f"{arch}: prefill logits {logit_err}")
    log(f"[lm {arch}] all {toks.size} greedy tokens equal the plain replay")

    prefill = make_prefill_step(cfg, q_chunk=min(64, SERVE_LM["prompt_len"]))
    decode = make_decode_step(cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cache, last = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
    _log_by_kernel(f"lm {arch}, traced prefill", _by_kernel(prof))
    tok = torch.argmax(last[:, :cfg.vocab_size], -1).to(torch.int32)[:, None]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(params, cache, tok)
        torch.cuda.synchronize()
    _log_by_kernel(f"lm {arch}, traced decode step", _by_kernel(prof))
    del params, prompts, plain, warm, cache, last
    torch.cuda.empty_cache()
    return launches


def recurrent_phases(dev, card: str) -> list:
    """Phases 10-12; returns the two kernel records."""
    import numpy as np

    from repro_torch.kernels.rglru_scan import kernel as GK
    from repro_torch.kernels.rglru_scan import ref as GR
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6 import ref as WR

    errs = recurrence_checks(dev)
    launches = {"rglru_scan": 0, "rwkv6": 0}
    for arch in RECURRENT_ARCHS:
        for name, n in serve_recurrent(arch, dev).items():
            launches[name] += n

    # 12. times at the serving shapes, as the main path calls the kernels:
    # the prefill from a zero state (None), the decode from a carried one
    rng = np.random.default_rng(3)
    B, T, gen, f32 = (SERVE_LM["batch"], SERVE_LM["prompt_len"],
                      SERVE_LM["gen"], 4)
    shapes = {"rglru_scan": {"prefill": (B, T, 4096), "decode": (B, 1, 4096)},
              "rwkv6": {"prefill": (B, T, 32, 64), "decode": (B, 1, 32, 64)}}
    records = []
    for name, per_shape in shapes.items():
        src, replaces, _ = RECURRENCES[name]
        mix = {"prefill": 1, "decode": gen - 1}  # launches per layer
        timed = {}
        for phase, shape in per_shape.items():
            state = phase == "decode"
            if name == "rglru_scan":
                Bs, Ts, L = shape
                nbytes = (3 * Bs * Ts * L + (2 if state else 1) * Bs * L) * f32

                def inputs():
                    a, b, h0 = _scan_inputs(rng, dev, *shape)
                    return a, b, h0 if state else None
                ops = 2 * Bs * Ts * L
                launch, plain_fn = GK.launch, GR.rglru_scan
            else:
                Bs, Ts, H, hd = shape
                nbytes = (5 * Bs * Ts * H * hd + H * hd
                          + (2 if state else 1) * Bs * H * hd * hd) * f32

                def inputs():
                    r, k, v, logw, u, s0 = _rwkv_inputs(rng, dev, *shape)
                    return r, k, v, logw, u, s0 if state else None
                ops = 5 * Bs * H * Ts * hd * hd
                launch, plain_fn = WK.launch, WR.rwkv6
            args = inputs()

            def kernel(args=args, launch=launch):
                launch(*args)

            def plain(args=args, plain_fn=plain_fn):
                plain_fn(*args)

            # cold: rotate over input sets of more than twice the L2
            n_sets = max(3, math.ceil(2 * L2_BYTES / nbytes))
            sets = [inputs() for _ in range(n_sets)]
            turn = itertools.cycle(sets)

            def kernel_cold(turn=turn, launch=launch):
                launch(*next(turn))
            # the kernel is one launch per call: a window that saw fewer
            # is profiled again, and if none is whole the kernel's time is
            # the one queued behind a spin (the plain version's: the
            # back-to-back time, an upper bound)
            dev_ms = {"kernel": device_ms(kernel, reps=10, launches=1),
                      "plain": device_ms(plain)}
            wall_ms = {"kernel": cuda_time_ms(kernel, reps=50),
                       "plain": cuda_time_ms(plain, reps=5)}
            queued = queued_ms(kernel)
            log(f"[time] {name} {phase} {list(shape)} kernel: CUDA events "
                f"queued behind a spin kernel {queued:.6f} ms per launch")
            cold_dev = device_ms(kernel_cold, reps=n_sets, launches=1)
            cold_queued = queued_ms(kernel_cold, reps=n_sets)
            log(f"[time] {name} {phase} {list(shape)} kernel, cold ({n_sets} "
                f"rotated input sets, {n_sets * nbytes / 1e6:.1f} MB): device "
                f"{cold_dev:.6f} ms per launch (0 if the profiler missed "
                f"launches); queued behind a spin kernel {cold_queued:.6f} ms")
            for arm in dev_ms:
                if dev_ms[arm] <= 0.0:
                    dev_ms[arm] = queued if arm == "kernel" else wall_ms[arm]
                    log(f"[time] {name} {phase} {arm}: the profiler missed "
                        f"launches; using the CUDA-event time")
                log(f"[time] {name} {phase} {list(shape)} {arm}: device "
                    f"{dev_ms[arm]:.6f} ms per launch; wall (CUDA events, "
                    f"back-to-back) {wall_ms[arm]:.6f} ms")
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            log(f"[time] {name} {phase}: bound {max(bytes_ms, ops_ms):.6f} "
                f"ms (bytes {nbytes / 1e6:.3f} MB -> {bytes_ms:.6f} ms; "
                f"{ops / 1e6:.3f} MFLOP -> {ops_ms:.6f} ms)")
            timed[phase] = (dev_ms["kernel"], dev_ms["plain"], bytes_ms,
                            ops_ms)
        # per launch over the main path's mix: 1 prefill and gen-1 decode
        # launches per layer
        n = sum(mix.values())
        mean = [sum(mix[p] * timed[p][i] for p in mix) / n for i in range(4)]
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs[name], "ms": mean[0], "plain_ms": mean[1],
               "bound_ms": sum(mix[p] * max(timed[p][2], timed[p][3])
                               for p in mix) / n,
               "bound_by": "bytes" if mean[2] >= mean[3] else "operations",
               "library_ms": None}
        log(f"[time] {name}: {rec['ms']:.6f} ms device per launch over the "
            f"path's mix (1 prefill : {gen - 1} decode); bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}); plain "
            f"{rec['plain_ms']:.6f} ms; no library call computes it")
        records.append(rec)
    log(f"[time] recurrence bounds: {HBM_BYTES_PER_S / 1e12:g} TB/s, "
        f"{F32_OPS_PER_S / 1e12:g} TFLOP/s f32 (H100 SXM data sheet); card "
        f"{card}")
    return records


# -- [decode]: M2/M3 and the serve CLI's subcommands -------------------------

def _seq_buffers(kernel: str, dev, rng, d_model: int, vocab: int,
                 prompt_len: int = 7, slots: int = 4, steps: int = 5):
    """One surrogate task's buffers on the card, twice (M2/M3's and the
    plain version's), and its scalars: a seeded prompt padded to 16s for
    ``SeqPrefill``; for ``SeqDecode`` random states and slot rows of every
    kind (live, fewer tokens than the round, inactive), row 0 live for the
    whole round."""
    import numpy as np
    import torch

    from repro_torch.serving.kernels import init_state

    if kernel == "SeqPrefill":
        P = -(-prompt_len // 16) * 16
        prompt = np.zeros((1, P), np.int32)
        prompt[0, :prompt_len] = rng.integers(0, vocab, prompt_len)
        bufs = (np.zeros((1, 8), np.int32),
                init_state(int(rng.integers(1000)), d_model)[None], prompt)
        scalars = dict(P=P, D=d_model, vocab=vocab, prompt_len=prompt_len)
    else:
        state = rng.integers(-2**31, 2**31, (slots, d_model),
                             dtype=np.int64).astype(np.int32)
        tbl = np.zeros((slots, 8), np.int32)
        tbl[:, 0] = rng.integers(0, 2, slots)
        tbl[:, 1] = rng.integers(0, steps + 1, slots)
        tbl[0, :2] = (1, steps)
        tbl[:, 2] = rng.integers(0, vocab, slots)
        bufs = (np.full((slots, steps), -1, np.int32), state, tbl)
        scalars = dict(S=slots, D=d_model, R=steps, vocab=vocab)
    mine = tuple(torch.tensor(b, device=dev) for b in bufs)
    return mine, tuple(b.clone() for b in mine), scalars


def _seq_launch(kernel: str, words, bufs, scalars, budget: int, flag):
    from repro_torch.kernels.seq_lm import kernel as QK

    if kernel == "SeqPrefill":
        return QK.seq_prefill_mega(words, *bufs, scalars["prompt_len"],
                                   scalars["vocab"], budget, flag)
    return QK.seq_decode_mega(words, *bufs, scalars["vocab"], budget, flag)


def _seq_step(kernel: str, mine, plain, scalars, ctx, budget: int, flag,
              boundary: int):
    """One launch of M2/M3 and of its plain version (the host loop over the
    task body, on the card) from ``ctx`` with the flag at ``boundary``:
    equal context words, chunk counts and progress, buffers bitwise.
    Returns (the context after it, max abs difference of the buffers)."""
    import numpy as np
    import torch

    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.preemption import make_megakernel

    kd = get_kernel(kernel)
    flag.write(boundary)
    words, n = _seq_launch(kernel, ctx.to_words(), mine, scalars, budget,
                           flag).result()
    progress = flag.progress()
    _, ints, floats = kd.bundle(*mine, **scalars).padded()
    want, _, want_n = make_megakernel(kd)(ctx, plain, ints, floats, budget,
                                          flag).result()
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(mine, plain))
    if (n != want_n or progress != n or err != 0
            or not np.array_equal(words, want.to_words())):
        raise AssertionError(
            f"[decode] {kernel} at boundary {boundary}, budget {budget}: "
            f"chunks {n} / {want_n}, progress {progress}, buffers differ by "
            f"{err}, context words equal "
            f"{np.array_equal(words, want.to_words())}")
    flag.clear()
    return want, err


def _seq_checks(dev, rng) -> dict:
    """M2/M3 against their plain versions at the surrogate's published
    scale: every boundary of a small task (the flag at boundary k of a
    fresh task, then at k for every resume) at budgets 1, 2 and 4, then
    random boundaries of tasks at the main path's shapes (a 128-token
    prompt; 32 slots of an 8-token round) at budget 1.  Returns the
    launches compared and the largest difference, per kernel."""
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import PreemptFlag

    flag = PreemptFlag(dev)
    d, v = SURROGATE["d_model"], SURROGATE["vocab"]
    out = {}
    for kernel in ("SeqPrefill", "SeqDecode"):
        steps = 7 if kernel == "SeqPrefill" else 5
        n_launch, err = 0, 0
        for budget in SEQ_BUDGETS:
            for k in range(0, -(-steps // budget) + 1):
                mine, plain, sc = _seq_buffers(kernel, dev, rng, d, v)
                ctx = ContextRecord.fresh()
                while not ctx.done:
                    ctx, e = _seq_step(kernel, mine, plain, sc, ctx, budget,
                                       flag, k)
                    n_launch, err = n_launch + 1, max(err, e)
        small = n_launch
        shape = (dict(prompt_len=DECODE_MAIN["prompt_len"])
                 if kernel == "SeqPrefill" else
                 dict(slots=DECODE_MAIN["slots"],
                      steps=DECODE_MAIN["round_tokens"]))
        big = shape.get("prompt_len", shape.get("steps"))
        for _ in range(SEQ_RANDOM_TASKS):
            mine, plain, sc = _seq_buffers(kernel, dev, rng, d, v, **shape)
            ctx = ContextRecord.fresh()
            while not ctx.done:
                ctx, e = _seq_step(kernel, mine, plain, sc, ctx, 1, flag,
                                   int(rng.integers(1, big + 1)))
                n_launch, err = n_launch + 1, max(err, e)
        log(f"[decode] {kernel} ({'M2' if kernel == 'SeqPrefill' else 'M3'}) "
            f"equals its plain version at d_model {d}, vocab {v}: {small} "
            f"launches at every boundary of a {steps}-step task (budgets "
            f"{SEQ_BUDGETS}), {n_launch - small} at random boundaries of "
            f"{SEQ_RANDOM_TASKS} tasks of {shape}; max abs difference {err}")
        out[kernel] = {"launches": n_launch, "err": err}
    return out


def _seq_counts() -> dict:
    from repro_torch.kernels.seq_lm import kernel as QK

    return {k: QK.MEGA_LAUNCHES[k] for k in ("SeqPrefill", "SeqDecode")}


def _decode_run(tag: str, engine: str, preempt_every: int, **shape) -> dict:
    """``serve_decode`` on cuda:0 (every stream verified against the
    oracle inside it), with the M2/M3 counts zeroed just before and read
    just after."""
    from repro_torch.kernels.seq_lm import kernel as QK
    from repro_torch.launch.serve import serve_decode

    QK.MEGA_LAUNCHES.reset()
    QK.STEPS.reset()
    t0 = time.perf_counter()
    try:
        rep = serve_decode(engine=engine, preempt_every=preempt_every,
                           quiet=True, **shape)
    except SystemExit as e:  # a stream diverged from the oracle
        raise AssertionError(f"[decode] {tag}: {e}") from None
    wall = time.perf_counter() - t0
    counts = _seq_counts()
    log(f"[decode] {tag}, {engine}, preempt every {preempt_every}: "
        f"{rep['n_finished']} sequences ({rep['lm']}), every stream equal to "
        f"the oracle; {rep['tokens_out']} tokens at {rep['tokens_per_s']:.3f} "
        f"tok/s, TTFT p50 {rep['ttft_p50_s'] * 1e3:.3f} ms / p99 "
        f"{rep['ttft_p99_s'] * 1e3:.3f} ms; {rep['prefill_tasks']} prefills, "
        f"{rep['decode_rounds']} rounds ({rep['state_device_rounds']} "
        f"device-resident), {rep['decode_preemptions']} preempted; M2/M3 "
        f"launches {counts}, steps "
        f"{ {k: QK.STEPS[k] for k in counts} }; {wall:.3f} s")
    rep["_counts"], rep["_wall_s"] = counts, wall
    return rep


def _require_seq_launches(tag: str, rep: dict, engine: str):
    """In megakernel mode every prefill is one M2 launch and every round at
    least one M3 launch, at most one more a preemption (a round preempted
    before its dispatch launches nothing); elsewhere none."""
    c = rep["_counts"]
    if engine == "megakernel":
        rounds = rep["decode_rounds"]
        ok = (c["SeqPrefill"] == rep["prefill_tasks"]
              and rounds <= c["SeqDecode"]
              <= rounds + rep["decode_preemptions"])
        want = (f"{rep['prefill_tasks']} M2, {rounds} to "
                f"{rounds + rep['decode_preemptions']} M3")
    else:
        ok = c == {"SeqPrefill": 0, "SeqDecode": 0}
        want = "none"
    if not ok:
        raise AssertionError(f"[decode] {tag}: M2/M3 launches {c}, "
                             f"expected {want}")


def _recording(cls, name: str, calls: list):
    """Wrap ``cls.name`` to record each call's first argument and result;
    returns the undo."""
    orig = getattr(cls, name)

    def wrapper(self, *args, **kw):
        out = orig(self, *args, **kw)
        calls.append((args[0] if args else None, out))
        return out

    setattr(cls, name, wrapper)
    return lambda: setattr(cls, name, orig)


def _blur_subcommands(dev) -> dict:
    """``serve_task_stream`` and ``serve_cluster`` once each at 4096^2 in
    megakernel mode: every image equal to the plain version on the card,
    M1 launched and B1 never."""
    import torch

    from repro_torch.cluster.frontend import ClusterFrontend
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.kernels.blur import kernel as K
    from repro_torch.kernels.blur.tasks import result_image
    from repro_torch.launch.serve import serve_cluster, serve_task_stream

    out = {}
    for tag, fn, cls, name in (
            ("scheduler", serve_task_stream, Scheduler, "run"),
            ("cluster", serve_cluster, ClusterFrontend, "submit")):
        calls = []
        undo = _recording(cls, name, calls)
        _reset_counts()
        t0 = time.perf_counter()
        try:
            rep = fn(size=SIZE, engine="megakernel", quiet=True)
        finally:
            undo()
        wall = time.perf_counter() - t0
        _, launches, mega = _counts()
        if tag == "scheduler":
            done = [(t, t.result) for t in calls[0][0]]
        else:
            done = [(t, h.result(timeout=0)) for t, h in calls]
        err = 0.0
        for t, res in done:
            iters = int(t.args.ints[2])
            t.result = res
            kind = "median" if t.kernel == "MedianBlur" else "gaussian"
            err = max(err, check(kind, torch.tensor(result_image(t, iters)),
                                 _plain_image(t.args.bufs[0], iters,
                                              t.kernel, dev)))
        n = len(done)
        log(f"[decode] serve {tag} at {SIZE}^2, megakernel: {rep['n_done']}/"
            f"{n} tasks in {rep['wall_s']:.3f} s ({rep['throughput_tps']:.3f} "
            f"tasks/s), turnaround p50 {rep['turnaround_p50_s']:.3f} s / p99 "
            f"{rep['turnaround_p99_s']:.3f} s; M1 launches {mega}, B1 "
            f"{launches}; every image equals the plain version (max abs "
            f"error {err:.3e}); {wall:.3f} s")
        if rep["n_done"] != n or sum(mega.values()) < n \
                or sum(launches.values()) != 0:
            raise AssertionError(f"[decode] serve {tag}: {rep['n_done']}/{n} "
                                 f"done, M1 {mega}, B1 {launches}")
        out[tag] = {"n_done": rep["n_done"], "wall_s": rep["wall_s"],
                    "turnaround_p99_s": rep["turnaround_p99_s"],
                    "m1_launches": mega}
    return out


def _seq_lag(kernel: str, dev, rng, flag, fresh) -> dict:
    """A flag write landing in a running M2/M3 launch at budget 1 (a
    ``SEQ_LAG_STEPS``-step task, every M3 row live all along): the host
    writes the flag once the launch has published ``SEQ_LAG_AT`` chunks,
    reads the progress word right after and spins on the launch's event, so
    the time is the card's answer, not a poll sleep; the exit must come at
    most 2 chunks past the progress read.  Then the launch armed before it
    starts must stop at boundary 1."""
    d, v = SURROGATE["d_model"], SURROGATE["vocab"]
    shape = (dict(prompt_len=SEQ_LAG_STEPS) if kernel == "SeqPrefill" else
             dict(slots=DECODE_MAIN["slots"], steps=SEQ_LAG_STEPS))
    mine, _, sc = _seq_buffers(kernel, dev, rng, d, v, **shape)
    if kernel == "SeqDecode":
        mine[2][:, 0] = 1                      # every row live all along
        mine[2][:, 1] = SEQ_LAG_STEPS
    tag = "M2" if kernel == "SeqPrefill" else "M3"
    lags = []
    for _ in range(SEQ_LAG_TRIALS):
        launch = _seq_launch(kernel, fresh.to_words(), mine, sc, 1, flag)
        if not _wait(lambda: flag.progress() >= SEQ_LAG_AT, timeout=30):
            raise AssertionError(f"[decode] the {tag} lag launch never "
                                 f"progressed")
        flag.write(1)
        t_w = time.perf_counter()
        at = flag.progress()
        while not launch.query():
            pass
        t_x = time.perf_counter()
        _, n = launch.result()
        flag.clear()
        lags.append(((t_x - t_w) * 1e6, n - at))
        if not 0 <= n - at <= 2 or n >= SEQ_LAG_STEPS:
            raise AssertionError(f"[decode] {tag}: the flag exit came "
                                 f"{n - at} chunks after the write ({n} "
                                 f"run)")
    # the same launch armed before it starts: its call, one chunk and the
    # event, with no flag write in flight
    armed = []
    for _ in range(SEQ_LAG_TRIALS):
        flag.write(1)
        t0 = time.perf_counter()
        launch = _seq_launch(kernel, fresh.to_words(), mine, sc, 1, flag)
        while not launch.query():
            pass
        armed.append((time.perf_counter() - t0) * 1e6)
        if launch.result()[1] != 1:
            raise AssertionError(f"[decode] an armed {tag} launch ran past "
                                 f"boundary 1")
        flag.clear()
    log(f"[decode] a flag write into a running {tag} launch ({shape}, "
        f"budget 1): host write -> the launch's event seen "
        f"{[round(t, 3) for t, _ in lags]} us, chunks after the device's "
        f"published progress {[c for _, c in lags]} (at most 2); a launch "
        f"armed before it starts: call -> its event seen "
        f"{[round(t, 3) for t in armed]} us, exit at boundary 1")
    return {"flag_to_exit_us": [t for t, _ in lags],
            "chunks_past_progress": [c for _, c in lags]}


def _seq_times(dev, rng, launches: dict, errs: dict) -> list:
    """M2/M3's device time per launch and per chunk at the main path's
    shapes (a 128-token prompt: 128 chunks at budget 1; a 32-slot round of
    8 steps: 8 chunks) at ``SEQ_TIME_BUDGETS``, the plain version's (the
    host loop's torch kernels), the bound, and the floor of one flag read
    a chunk, with ``seq_latency_probe``'s terms; then a flag write's exit
    lag on each."""
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import PreemptFlag, make_megakernel
    from repro_torch.controller.kernels import get_kernel
    from repro_torch.kernels.seq_lm import kernel as QK

    flag = PreemptFlag(dev)
    fresh = ContextRecord.fresh()
    d, v = SURROGATE["d_model"], SURROGATE["vocab"]
    records = []
    for kernel, name, shape in (
            ("SeqPrefill", "seq_prefill_mega",
             dict(prompt_len=DECODE_MAIN["prompt_len"])),
            ("SeqDecode", "seq_decode_mega",
             dict(slots=DECODE_MAIN["slots"],
                  steps=DECODE_MAIN["round_tokens"]))):
        tag = "M2" if kernel == "SeqPrefill" else "M3"
        mine, plain, sc = _seq_buffers(kernel, dev, rng, d, v, **shape)
        kd = get_kernel(kernel)
        _, ints, floats = kd.bundle(*plain, **sc).padded()
        entry = make_megakernel(kd)
        steps = shape.get("prompt_len", shape.get("steps"))
        rows = shape.get("slots", 1)
        geo = QK.plan(rows, d)

        def host_loop(entry=entry, plain=plain, ints=ints, floats=floats):
            entry(fresh, plain, ints, floats, 1, flag)

        dev_ms, hows = {}, {}
        for budget in SEQ_TIME_BUDGETS:
            def mega(kernel=kernel, mine=mine, sc=sc, budget=budget):
                return _seq_launch(kernel, fresh.to_words(), mine, sc,
                                   budget, flag)

            # the median of 3 profiler windows (a single window once read
            # half of M2's launch on the H100)
            dev_ms[budget] = sorted(_named_ms(mega, "seq_mega_kernel", 1)
                                    for _ in range(3))[1]
            hows[budget] = "torch.profiler, median of 3 windows"
            if dev_ms[budget] <= 0.0:
                dev_ms[budget] = queued_ms(mega, reps=5)
                hows[budget] = "queued behind a spin kernel"
            if budget == 1:
                wall_ms = cuda_time_ms(mega, reps=20)
        plain_ms, plain_how = device_ms(host_loop), "torch.profiler"
        if plain_ms <= 0.0:
            plain_ms, plain_how = queued_ms(host_loop, reps=5), \
                "queued behind a spin kernel"
        # the bytes one launch must move: the state read and written once,
        # the prompt (M2) or the slots table and the round's tokens (M3)
        state_b = rows * d * 4 * 2
        extra = (sc.get("P", 0) * 4 + 4 if kernel == "SeqPrefill"
                 else rows * 8 * 4 * 2 + rows * steps * 4)
        bytes_ms = (state_b + extra) / HBM_BYTES_PER_S * 1e3
        # 7 int32 operations an element a step (2 products, the injected
        # term's product, 3 sums, the row sum), at the table's f32 rate
        ops_ms = 7 * rows * d * steps / F32_OPS_PER_S * 1e3
        # the floor at budget 1: a chunk consumes one flag read issued no
        # earlier than the boundary before it, so the chunks follow one
        # another no faster than that read, as this design issues it
        # (ld.relaxed.sys), measured by the probe on this card in this run
        pr = QK.latency_probe(flag, d, v, warps=min(rows, 32))
        us = lambda c: c * pr["ns_per_cycle"] * 1e-3  # noqa: E731
        floor_ms = steps * us(pr["flag_relaxed"]) * 1e-3
        chunk_us = {b: dev_ms[b] / -(-steps // b) * 1e3 for b in dev_ms}
        log(f"[decode] {name} ({tag}) {shape}, {geo['compute_warps']} "
            f"compute warps of {geo['rows_per_warp']} rows and the watcher, "
            f"state {'in shared memory' if geo['resident'] else 'in global memory'}: "
            + "; ".join(f"budget {b}: {dev_ms[b]:.6f} ms device a launch "
                        f"({hows[b]}), {chunk_us[b]:.4f} us a chunk"
                        for b in dev_ms)
            + f"; wall (CUDA events, back to back, budget 1) "
            f"{wall_ms:.6f} ms a launch; the plain version (host loop, "
            f"torch kernels) {plain_ms:.6f} ms device a task ({plain_how}); "
            f"bound {max(bytes_ms, ops_ms) * 1e3:.4f} us a launch (bytes "
            f"{bytes_ms * 1e3:.4f}, operations {ops_ms * 1e3:.4f}); floor "
            f"(one flag read a chunk, {us(pr['flag_relaxed']):.4f} us) "
            f"{floor_ms * 1e3:.4f} us a launch at budget 1, "
            f"{floor_ms / dev_ms[1] * 100:.2f} % of its time")
        log(f"[decode] {name} latency probe (seq_latency_probe, "
            f"{min(rows, 32)} warps, measured, us a repetition at "
            f"{pr['ns_per_cycle']:.6f} ns a cycle): "
            + ", ".join(f"{k} {us(pr[k]):.4f}" for k in QK.PROBE_STEPS))
        if kernel == "SeqPrefill":
            # the earlier design's budget-1 chunk, part by part: its
            # boundary (barrier, progress store, ld.acquire.sys, barrier),
            # its step with the state in global memory, and what the two
            # left uncovered: the for_save control, the dependent prompt
            # read, and what the acquire read cost the step after it
            rest = us(pr["parent_chunk"] - pr["boundary"] - pr["m2_step"])
            log(f"[decode] the earlier M2 chunk (probe): "
                f"{us(pr['parent_chunk']):.4f} us = boundary "
                f"{us(pr['boundary']):.4f} (its flag read "
                f"{us(pr['flag_read']):.4f}) + step in global memory "
                f"{us(pr['m2_step']):.4f} + {rest:.4f} more, of which the "
                f"for_save control {us(pr['parent_control']):.4f}, the "
                f"dependent prompt read {us(pr['prompt_load']):.4f}, and "
                f"{us(pr['parent_chunk'] - pr['boundary'] - pr['parent_chunk_noflag']):.4f} "
                f"that the boundary adds to the chunk without it "
                f"({us(pr['parent_chunk_noflag']):.4f}); this design: control "
                f"{us(pr['control']):.4f}, step in shared memory "
                f"{us(pr['m2_step_resident']):.4f}, a read with that step "
                f"under it {us(pr['flag_overlap']):.4f} (the read alone "
                f"{us(pr['flag_relaxed']):.4f}), a barrier with a read in "
                f"flight {us(pr['bar_after_read']):.4f}, fence.sc.sys after "
                f"the progress store {us(pr['fence_sys']):.4f} (not taken: "
                f"over 0.2 us), a device-memory word {us(pr['device_read']):.4f}")
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/seq_lm.cu",
            "replaces": REPLACES_MEGA,
            "counterpart_of": f"make_megakernel (a lax.while_loop over "
                              f"{'seq_prefill' if kernel == 'SeqPrefill' else 'seq_decode'}"
                              f", src/repro/serving/kernels.py, not a "
                              f"pallas_call)",
            "launches": launches[kernel], "max_abs_err": errs[kernel],
            "ms": dev_ms[1], "per": f"launch of {steps} chunks",
            "ms_per_chunk": dev_ms[1] / steps,
            **{f"ms_budget_{b}": dev_ms[b] for b in dev_ms if b != 1},
            "floor_ms": floor_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None})
    for kernel, rec in zip(("SeqPrefill", "SeqDecode"), records):
        rec.update(_seq_lag(kernel, dev, rng, flag, fresh))
    return records


def decode_phase(dev) -> tuple:
    """[decode]: M2/M3 against their plain versions, the surrogate main
    path (serve decode at 64 sequences, megakernel, probes every 3rd
    round), its pipelined twin, the reference's defaults in both engines,
    the attention LM once pipelined, the CLI's blur subcommands at 4096^2
    in megakernel mode, the pipelined/megakernel A/B without probes, and
    M2/M3's times.  Returns (kernel records, summary)."""
    import numpy as np

    rng = np.random.default_rng(24)
    checked = _seq_checks(dev, rng)
    main_shape = dict(DECODE_MAIN, **SURROGATE)
    # the main path: counts zeroed inside, read right after
    main = _decode_run("main", "megakernel", DECODE_PREEMPT_EVERY,
                       **main_shape)
    _require_seq_launches("main", main, "megakernel")
    if main["decode_preemptions"] < 1:
        raise AssertionError("[decode] no round exited on the flag")
    launches = dict(main["_counts"])
    piped = _decode_run("main", "pipelined", DECODE_PREEMPT_EVERY,
                        **main_shape)
    _require_seq_launches("main, pipelined", piped, "pipelined")
    for engine in DECODE_AB:
        rep = _decode_run("reference defaults", engine, 0)
        _require_seq_launches("reference defaults", rep, engine)
    _decode_run("attention LM (reference defaults)", "pipelined", 0,
                lm="attention")
    blur = _blur_subcommands(dev)
    ab = {"pipelined": [], "megakernel": []}
    for engine in DECODE_AB:
        rep = _decode_run("A/B, no probes", engine, 0, **main_shape)
        _require_seq_launches("A/B", rep, engine)
        ab[engine].append({k: rep[k] for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "_wall_s")})
    for engine, runs in ab.items():
        log(f"[decode] A/B {engine}: tok/s "
            f"{[round(r['tokens_per_s'], 3) for r in runs]}, TTFT p50 "
            f"{[round(r['ttft_p50_s'] * 1e3, 3) for r in runs]} ms, p99 "
            f"{[round(r['ttft_p99_s'] * 1e3, 3) for r in runs]} ms")
    records = _seq_times(dev, rng, launches,
                         {k: v["err"] for k, v in checked.items()})
    summary = {"main": {k: main[k] for k in (
        "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "decode_preemptions",
        "decode_rounds", "prefill_tasks")}, "ab": ab, "blur": blur,
        "checked_launches": {k: v["launches"] for k, v in checked.items()}}
    return records, summary


# -- [train]: the training half at full width ---------------------------------

def _example(name: str):
    """``examples/<name>.py`` as a module (the examples are no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _CardSampler:
    """``nvidia-smi``'s SM clock (MHz), power draw (W) and temperature (C)
    every ``period_s`` on a thread while the block runs: whether the card
    held its clock through a long GEMM-bound run."""

    def __init__(self, period_s: float = 0.5):
        self.period_s, self.rows = period_s, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.period_s):
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                     "temperature.gpu", "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=30).stdout
                self.rows.append([float(v) for v in
                                  out.splitlines()[0].split(",")])
            except (OSError, subprocess.SubprocessError, IndexError,
                    ValueError):
                return  # no readable nvidia-smi: the summary says so

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)

    def summary(self) -> dict:
        if not self.rows:
            return {"samples": 0}
        clock, power, temp = zip(*self.rows)
        return {"samples": len(self.rows), "sm_mhz_min": min(clock),
                "sm_mhz_max": max(clock), "power_w_max": max(power),
                "temp_c_max": max(temp)}


def _timed_train(cfg, dev, tag: str, **kw) -> dict:
    """``train_loop`` on ``dev`` with a step clock: the step times (each
    loss is read back to the host before the next step starts), losses,
    peak device memory."""
    import torch

    from repro_torch.launch.train import train_loop

    ends = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, losses = train_loop(cfg, device=dev, quiet=True,
                               on_step=lambda step, m: ends.append(
                                   time.perf_counter()), **kw)
    step_s = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"[train] {tag}: a loss is not finite: "
                             f"{losses}")
    return {"state": state, "losses": losses, "step_s": step_s,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def train_phase(dev, card: str) -> dict:
    """[train]: RWKV-6 1.6B trained at full width in f32 through
    ``train_loop`` (step time, tokens/s, model-FLOP share of the f32 peak,
    peak memory; a nonzero gradient on every leaf the model reads, none
    through B4/B5), the ``torch_train_100m`` example's model with
    checkpoints, the crash-and-restart equivalence on the card, and the
    multi-tenant example: serving preempts training, whose final state
    must equal an uninterrupted run's."""
    import gc
    import os
    import shutil
    import statistics
    import tempfile

    import torch
    import torch.utils._pytree as pytree
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.ckpt.store import _flatten
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels.rglru_scan import kernel as GK
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.launch.train import train_loop
    from repro_torch.models import lm as LM
    from repro_torch.optim import AdamWConfig

    gc.collect()
    torch.cuda.empty_cache()
    out = {}

    # 1. RWKV-6 1.6B, full width and depth, f32
    cfg = get_config(TRAIN["arch"])
    first_grads = {}
    update = LM.adamw_update

    def watching(grads, *args, **kw):
        if not first_grads:
            for path, g in pytree.tree_flatten_with_path(grads)[0]:
                first_grads[pytree.keystr(path)] = bool((g != 0).any())
        return update(grads, *args, **kw)

    GK.LAUNCHES.reset()
    WK.LAUNCHES.reset()
    LM.adamw_update = watching
    try:
        with _CardSampler() as card_state:
            run = _timed_train(cfg, dev, "rwkv6", steps=TRAIN["steps"],
                               batch=TRAIN["batch"], seq=TRAIN["seq"])
    finally:
        LM.adamw_update = update
    recurrences = GK.LAUNCHES.total() + WK.LAUNCHES.total()
    # one step more, traced: the card's busy share and where its time goes
    opt = AdamWConfig(warmup_steps=1, total_steps=TRAIN["steps"])
    batch = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
        global_batch=TRAIN["batch"])).batch(TRAIN["steps"])
    step_fn = LM.make_train_step(cfg, opt, remat="full", q_chunk=64)
    with tempfile.TemporaryDirectory() as tmp:
        prof_json = os.path.join(tmp, "profile.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("train_window"):
                state, metrics = step_fn(run.pop("state"), batch)
                float(metrics["loss"])
                torch.cuda.synchronize()
        prof.export_chrome_trace(prof_json)
        share = _busy_share(prof_json, "train_window")
    _log_by_kernel("train, traced step", _by_kernel(prof))
    log(f"[train] traced step: the card busy {share['busy_ms']:.3f} ms of "
        f"the {share['window_ms']:.3f} ms window, busy share "
        f"{share['busy_share']:.4f}; {share['kernel_n']} kernels "
        f"({share['kernel_ms']:.3f} ms), {share['gpu_memcpy_n']} copies, "
        f"{share['gpu_memset_n']} memsets")
    del state, metrics, prof
    zero = sorted(k for k, nonzero in first_grads.items() if not nonzero)
    # RWKV's output gate g is computed and never applied (the reference's
    # parity choice), so mu_g and wg are the leaves the loss never reads
    unread = [k for k in first_grads if k.endswith(("['mu_g']", "['wg']"))]
    if zero != sorted(unread) or len(unread) != 2:
        raise AssertionError(f"[train] rwkv6: leaves without a gradient on "
                             f"the first step {zero}; expected exactly "
                             f"{sorted(unread)} (B4/B5 would cut the "
                             f"time-mix projections)")
    if recurrences:
        raise AssertionError(f"[train] the training route launched B4/B5 "
                             f"{recurrences} times")
    losses, step_s = run["losses"], run["step_s"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[train] rwkv6: the loss did not fall: "
                             f"{losses}")
    med = statistics.median(step_s[1:])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    n_params = cfg.param_count()
    flop = 6 * n_params * tokens
    out["rwkv6"] = {
        "params": n_params, "step_s_median": med,
        "step_s": step_s, "tokens_per_s": tokens / med,
        "mfu_f32": flop / med / F32_OPS_PER_S,
        "model_tflop_per_step": flop / 1e12,
        "peak_gb": run["peak_gb"], "loss_first": losses[0],
        "loss_last": losses[-1], "leaves": len(first_grads),
        "zero_grad_leaves": zero, "b4_b5_launches": recurrences,
        "card": card_state.summary(),
        "traced_step": {k: share[k] for k in ("window_ms", "busy_ms",
                                              "busy_share", "kernel_n")}}
    log(f"[train] rwkv6-1.6b f32, {n_params / 1e9:.3f} B params, batch "
        f"{TRAIN['batch']} x seq {TRAIN['seq']}, {TRAIN['steps']} steps: "
        f"step {med * 1e3:.3f} ms (median of steps 2-{TRAIN['steps']}; all, "
        f"the first with the weights' draw, "
        f"{[round(t * 1e3, 3) for t in step_s]}), {tokens / med:.1f} tokens/s, "
        f"mfu_f32 {flop / med / F32_OPS_PER_S:.4f} ({flop / 1e12:.3f} model "
        f"TFLOP a step over {F32_OPS_PER_S / 1e12:g} TFLOP/s; remat adds a "
        f"forward), peak {run['peak_gb']:.3f} GB, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {len(first_grads) - len(zero)} of "
        f"{len(first_grads)} leaves with a nonzero first-step gradient (the "
        f"other two: RWKV's unapplied gate, as the reference); B4/B5 "
        f"launched {recurrences} times; card {card}, during the run "
        f"{card_state.summary()}")
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the train_100m example's model with checkpoints, then restart
    log(f"[train] allocated before the 100m run: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        m100 = _example("torch_train_100m").config()
        run = _timed_train(m100, dev, "100m", steps=TRAIN_100M["steps"],
                           batch=8, seq=256, lr=6e-4,
                           ckpt_base=os.path.join(tmp, "m100", "ck"),
                           ckpt_every=TRAIN_100M["ckpt_every"])
        del run["state"]
        med = statistics.median(run["step_s"][1:])
        written = sorted(os.listdir(os.path.join(tmp, "m100")))
        if not any(f.endswith(".json") for f in written):
            raise AssertionError(f"[train] 100m: no checkpoint written: "
                                 f"{written}")
        out["100m"] = {"params": m100.param_count(), "step_s_median": med,
                       "step_s": run["step_s"],
                       "tokens_per_s": 8 * 256 / med,
                       "peak_gb": run["peak_gb"],
                       "loss_first": run["losses"][0],
                       "loss_last": run["losses"][-1]}
        log(f"[train] {m100.name} ({m100.param_count() / 1e6:.1f} M params) "
            f"{TRAIN_100M['steps']} steps, a checkpoint every "
            f"{TRAIN_100M['ckpt_every']}: step {med * 1e3:.3f} ms (median, "
            f"checkpoint steps included; all "
            f"{[round(t * 1e3, 3) for t in run['step_s']]}), loss "
            f"{run['losses'][0]:.4f} -> "
            f"{run['losses'][-1]:.4f}, peak {run['peak_gb']:.3f} GB, files "
            f"{written}")

        # 5 straight steps against a crash after step 3's checkpoint and a
        # restart, at the reference test's shape
        h2o = get_config("h2o-danube-3-4b").reduced()
        kw = dict(steps=5, batch=2, seq=32, quiet=True, device=dev)

        class Crash(Exception):
            pass

        def crash(step, metrics):
            if step + 1 == 3:
                raise Crash

        full, losses = train_loop(h2o, ckpt_every=100, ckpt_base=os.path.join(
            tmp, "a", "ck"), **kw)
        try:
            train_loop(h2o, ckpt_every=3, on_step=crash,
                       ckpt_base=os.path.join(tmp, "b", "ck"), **kw)
            raise AssertionError("[train] the crash hook did not fire")
        except Crash:
            pass
        resumed, tail = train_loop(h2o, ckpt_every=100,
                                   ckpt_base=os.path.join(tmp, "b", "ck"),
                                   **kw)
        a, b = _flatten(full)[0], _flatten(resumed)[0]
        diff = max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))
        bitwise = all(torch.equal(x, y) for x, y in zip(a, b))
        ok = all(torch.allclose(x, y, rtol=1e-5, atol=1e-5)
                 for x, y in zip(a, b))
        out["restart"] = {"max_abs_diff": diff, "bitwise": bitwise,
                          "losses": losses, "resumed_losses": tail}
        log(f"[train] restart (h2o-danube reduced, batch 2, seq 32): 5 "
            f"straight against crash after 3 + restart: max |diff| "
            f"{diff:.3e} over {len(a)} leaves, bitwise {bitwise}; losses "
            f"{losses[3:]} against {tail}")
        if not ok or not all(math.isfinite(v) for v in losses + tail):
            raise AssertionError(f"[train] restart differs: {diff:.3e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 3. the multi-tenant example on cuda:0
    mt = _example("torch_multi_tenant_serve")
    t0 = time.perf_counter()
    got, want = mt.run(dev), mt.run(dev, serve=False)
    wall = time.perf_counter() - t0
    diff = max(float(abs(x.astype("float64") - y).max())
               for x, y in zip(got["state"], want["state"]))
    how = "as is"
    if diff != 0.0:
        # a resumed chunk may run on the other region's stream: retry with
        # deterministic algorithms and a fixed cuBLAS workspace
        log(f"[train] multi-tenant: final state differs by {diff:.3e} from "
            f"the uninterrupted run; rerunning both deterministically")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        try:
            got, want = mt.run(dev), mt.run(dev, serve=False)
        finally:
            torch.use_deterministic_algorithms(False)
        diff = max(float(abs(x.astype("float64") - y).max())
                   for x, y in zip(got["state"], want["state"]))
        how = "deterministic algorithms, CUBLAS_WORKSPACE_CONFIG=:4096:8"
    rep = got["report"]
    out["multi_tenant"] = {"preemptions": got["preemptions"],
                           "regions": got["regions"], "max_abs_diff": diff,
                           "how": how, "n_done": rep["n_done"],
                           "wall_s": got["wall_s"],
                           "wall_uninterrupted_s": want["wall_s"]}
    log(f"[train] multi-tenant (h2o-danube reduced, {mt.TRAIN_STEPS} steps, "
        f"{mt.N_REQUESTS} serving requests, 2 regions on {dev}): training "
        f"preempted {got['preemptions']}x on regions {got['regions']}, "
        f"{rep['n_done']} done; final state against the uninterrupted run: "
        f"max |diff| {diff:.3e} ({how}); {got['wall_s']:.3f} s against "
        f"{want['wall_s']:.3f} s uninterrupted ({wall:.3f} s for both)")
    if got["preemptions"] < 1 or rep["n_done"] != 1 + mt.N_REQUESTS:
        raise AssertionError("[train] multi-tenant: training was not "
                             "preempted, or a task did not finish")
    if diff > 1e-6:
        raise AssertionError(f"[train] multi-tenant: final state differs "
                             f"by {diff:.3e}")
    return out


# -- [encdec]: the encoder-decoder stack and the modality frontends ----------

def _b_launches() -> dict:
    """Launches of B1-B5 so far (the [encdec] path must reach none)."""
    from repro_torch.kernels.blur import kernel as K
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru_scan import kernel as GK
    from repro_torch.kernels.rwkv6 import kernel as WK

    return {name: mod.LAUNCHES.total() for name, mod in
            (("B1", K), ("B2", FK), ("B3", DK), ("B4", GK), ("B5", WK))}


def _synced(fn):
    """(fn(), wall seconds) with the card synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _greedy_gaps(params, prompts, frontend, cfg, gen: int):
    """``generate``'s greedy loop that also keeps, at every step, the gap
    between the two largest logits.  Returns (tokens [B, gen], gaps [B,
    gen], the prefill's last logits), as numpy."""
    import torch

    from repro_torch.models import transformer as TF
    from repro_torch.models.lm import make_prefill_step

    prefill = make_prefill_step(cfg, q_chunk=min(64, prompts.shape[1]))
    cache, last = prefill(params, {"tokens": prompts, "frontend": frontend})
    logits, toks, gaps = last[:, :cfg.vocab_size].float(), [], []
    for step in range(gen):
        if step:
            lg, cache = TF.decode_step(params, cache, toks[-1], cfg)
            logits = lg[:, 0, :cfg.vocab_size].float()
        top2 = torch.topk(logits, 2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).cpu())
        toks.append(torch.argmax(logits, -1).to(torch.int32)[:, None])
    return (torch.cat(toks, 1).cpu().numpy(), torch.stack(gaps, 1).numpy(),
            last.cpu())


def _teacher_forced(params, text, frontend, cfg, q_chunk: int = 64) -> dict:
    """Prefill ``text[:, :1]`` with the frontend input, then decode the
    rest of ``text`` token by token into a cache long enough to hold it
    all, against ``forward``'s logits over the whole text.  Returns the
    largest difference, forward's largest logit, and whether the
    cross-attention cache (where there is one) came through the decode
    steps bitwise unchanged."""
    import torch

    from repro_torch.models import transformer as TF
    from repro_torch.models.lm import make_prefill_step

    B, n = text.shape
    logits, _, _ = TF.forward(params, text, cfg, frontend_embeds=frontend,
                              q_chunk=q_chunk)
    pre, _ = make_prefill_step(cfg, q_chunk=q_chunk)(
        params, {"tokens": text[:, :1], "frontend": frontend})
    T0 = pre["pos"]
    cache = TF.init_cache(cfg, B, T0 + n - 1, device=text.device)
    for sn, c in pre["blocks"].items():
        for k, v in c.items():
            cache["blocks"][sn][k][:, :, :T0] = v
    enc = pre.get("enc")
    if enc is not None:
        cache["enc"] = enc
        enc_before = {k: v.clone() for k, v in enc.items()}
    cache["pos"] = T0
    err = 0.0
    for t in range(1, n):
        lg, cache = TF.decode_step(params, cache, text[:, t:t + 1], cfg)
        err = max(err, float((lg[:, 0] - logits[:, T0 - 1 + t]).abs().max()))
    same = None if enc is None else all(
        torch.equal(cache["enc"][k], v) for k, v in enc_before.items())
    return {"max_abs_err": err, "max_logit": float(logits.abs().max()),
            "positions": n - 1, "prefill_pos": T0, "enc_unchanged": same}


def _traced_decode(params, prompts, frontend, cfg, tag: str) -> dict:
    """Decode steps after a prefill and a warm step, traced by
    ``torch.profiler``: one with the card's activity only (device time by
    kernel), one with the host's too (the card's busy share in the step's
    window)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models.lm import make_decode_step, make_prefill_step

    prefill = make_prefill_step(cfg, q_chunk=min(64, prompts.shape[1]))
    decode = make_decode_step(cfg)
    cache, last = prefill(params, {"tokens": prompts, "frontend": frontend})
    tok = torch.argmax(last[:, :cfg.vocab_size], -1).to(torch.int32)[:, None]
    tok, cache = decode(params, cache, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tok, cache = decode(params, cache, tok)
        torch.cuda.synchronize()
    by_kernel = _by_kernel(prof)
    _log_by_kernel(tag, by_kernel)
    with tempfile.TemporaryDirectory() as tmp:
        prof_json = os.path.join(tmp, "profile.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("decode_window"):
                decode(params, cache, tok)
                torch.cuda.synchronize()
        prof.export_chrome_trace(prof_json)
        share = _busy_share(prof_json, "decode_window")
    log(f"[{tag}] the card busy {share['busy_ms']:.3f} ms of the "
        f"{share['window_ms']:.3f} ms window (host and card traced), busy "
        f"share {share['busy_share']:.4f}; {share['kernel_n']} kernels")
    return {"device_ms": sum(ms for ms, _ in by_kernel.values()),
            "kernels": sum(n for _, n in by_kernel.values()),
            **{k: share[k] for k in ("busy_ms", "window_ms", "busy_share")}}


def _whisper_serve(dev, card: str) -> dict:
    """whisper-tiny served through ``serve()`` on cuda:0, replayed on the
    CPU, decoded teacher-forced, one decode step traced."""
    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as TF

    cfg, sv = get_config("whisper-tiny"), WHISPER_SERVE
    toks = S.serve(cfg, **sv)               # cuda:0, the entry point
    if toks.shape != (sv["batch"], sv["gen"]) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"[encdec] whisper: bad tokens {toks.shape}")
    (params, prompts, frames), draw_s = _synced(lambda: S.draw(
        cfg, batch=sv["batch"], prompt_len=sv["prompt_len"], seed=sv["seed"],
        device=dev))
    torch.cuda.reset_peak_memory_stats(dev)
    run = S.generate(params, prompts, cfg, gen=sv["gen"], frontend=frames)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    _, encode_s = _synced(lambda: TF.encode(
        params, frames, cfg, q_chunk=min(64, sv["prompt_len"])))
    if not np.array_equal(run["tokens"], toks):
        raise AssertionError("[encdec] whisper: generate's tokens differ "
                             "from serve()'s on the same draws")

    # the same weights, frames and prompts on the CPU
    cpu = pytree.tree_map(lambda t: t.cpu(), params)
    (cpu_toks, gaps, cpu_last), cpu_s = _synced(lambda: _greedy_gaps(
        cpu, prompts.cpu(), frames.cpu(), cfg, sv["gen"]))
    logit_err = float((run["logits"].cpu() - cpu_last).abs().max())
    first_diff = []
    for b in range(sv["batch"]):
        off = np.flatnonzero(cpu_toks[b] != toks[b])
        if off.size:
            first_diff.append({"row": b, "step": int(off[0]),
                               "cpu_gap": float(gaps[b, off[0]])})
    log(f"[encdec] whisper card vs CPU ({cpu_s:.3f} s on the CPU): prefill "
        f"logits max_abs_err {logit_err:.3e} (tolerance {LOGIT_TOL:g}); "
        f"greedy streams {'equal' if not first_diff else first_diff}")
    if not logit_err <= LOGIT_TOL:
        raise AssertionError(f"[encdec] whisper: prefill logits differ "
                             f"from the CPU's by {logit_err}")
    if any(not d["cpu_gap"] < GAP_TOL for d in first_diff):
        raise AssertionError(f"[encdec] whisper: a greedy stream differs "
                             f"from the CPU's at a clear step: "
                             f"{first_diff}")

    text = torch.cat([prompts, torch.as_tensor(toks, device=dev)], 1)
    teacher = _teacher_forced(params, text, frames, cfg)
    log(f"[encdec] whisper teacher-forced decode of {teacher['positions']} "
        f"positions after a 1-token prefill: max_abs_err vs forward "
        f"{teacher['max_abs_err']:.3e} (tolerance {TEACHER_TOL:g}; max "
        f"|logit| {teacher['max_logit']:.3f}); cache['enc'] unchanged "
        f"bitwise: {teacher['enc_unchanged']}")
    if not teacher["max_abs_err"] <= TEACHER_TOL:
        raise AssertionError(f"[encdec] whisper: decode differs from "
                             f"forward by {teacher['max_abs_err']}")
    if teacher["enc_unchanged"] is not True:
        raise AssertionError("[encdec] whisper: decode changed cache['enc']")
    traced = _traced_decode(params, prompts, frames, cfg,
                            "encdec whisper, traced decode step")
    n_dec = sv["batch"] * (sv["gen"] - 1)
    out = {"params": sum(_numel(params)), "draw_s": draw_s,
           "encode_s": encode_s, "prefill_s": run["prefill_s"],
           "decode_s": run["decode_s"],
           "decode_tokens_per_s": n_dec / run["decode_s"],
           "peak_gb": peak_gb, "prefill_logit_err_vs_cpu": logit_err,
           "streams_first_diff": first_diff,
           "teacher_forced_err": teacher["max_abs_err"],
           "traced_decode_step": traced}
    log(f"[encdec] whisper-tiny f32 ({out['params'] / 1e6:.3f} M params, "
        f"batch {sv['batch']} x {cfg.encoder_seq} frames, prompt "
        f"{sv['prompt_len']}, {sv['gen']} greedy tokens): encode "
        f"{encode_s:.4f} s, prefill (encode included) "
        f"{run['prefill_s']:.4f} s, decode {out['decode_tokens_per_s']:.3f} "
        f"tokens/s ({run['decode_s']:.4f} s for {sv['gen'] - 1} steps), "
        f"peak {peak_gb:.3f} GB; card {card}")
    return out


def _whisper_train(dev, card: str) -> dict:
    """whisper-tiny trained 8 steps at batch 8 x 64 text tokens with 1500
    frames: a falling finite loss and a nonzero, finite first-step
    gradient on every leaf."""
    import statistics

    import torch
    import torch.utils._pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import lm as LM
    from repro_torch.optim import AdamWConfig

    cfg, tr = get_config("whisper-tiny"), WHISPER_TRAIN
    opt = AdamWConfig(warmup_steps=1, total_steps=tr["steps"])
    state = LM.init_train_state(
        cfg, opt, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev, param_dtype=torch.float32)
    step = LM.make_train_step(cfg, opt, remat="full", q_chunk=tr["q_chunk"])
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=tr["seq"],
                                      global_batch=tr["batch"]))
    frames = torch.randn((tr["batch"], cfg.encoder_seq, cfg.d_model),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    first = {}
    update = LM.adamw_update

    def watching(grads, *args, **kw):
        if not first:
            for path, g in pytree.tree_flatten_with_path(grads)[0]:
                first[pytree.keystr(path)] = (bool((g != 0).any()),
                                              bool(torch.isfinite(g).all()))
        return update(grads, *args, **kw)

    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    LM.adamw_update = watching
    try:
        for s in range(tr["steps"]):
            batch = dict(data.batch(s), frontend=frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
    finally:
        LM.adamw_update = update
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    bad = sorted(k for k, (nonzero, finite) in first.items()
                 if not (nonzero and finite))
    learned = [k for k in first if k.startswith(
        ("['frontend_proj']", "['encoder']", "['enc_norm']"))
        or "['normx']" in k or "['xattn']" in k]
    med = statistics.median(step_s[1:])
    tokens = tr["batch"] * tr["seq"]
    log(f"[encdec] whisper train ({tr['batch']} x {tr['seq']} tokens, "
        f"{cfg.encoder_seq} frames, remat full, q_chunk {tr['q_chunk']}): "
        f"losses {[round(v, 4) for v in losses]}; step "
        f"{med * 1e3:.3f} ms (median of steps 2-{tr['steps']}), "
        f"{tokens / med:.1f} text tokens/s, peak {peak_gb:.3f} GB; "
        f"{len(first) - len(bad)} of {len(first)} leaves with a nonzero "
        f"finite first-step gradient ({len(learned)} of them the frontend, "
        f"encoder and cross-attention); card {card}")
    if bad:
        raise AssertionError(f"[encdec] whisper: leaves without a nonzero "
                             f"finite first-step gradient: {bad}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"[encdec] whisper: the loss did not fall: "
                             f"{losses}")
    del state
    return {"step_s_median": med, "step_s": step_s,
            "text_tokens_per_s": tokens / med, "peak_gb": peak_gb,
            "losses": losses, "leaves": len(first),
            "encoder_side_leaves": len(learned)}


def _llava_serve(dev, card: str) -> dict:
    """llava-next-34b at full width with 8 of its 60 layers: 576 patch
    embeddings and 64 text tokens a request, 16 greedy tokens."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models.lm import make_prefill_step

    lv = LLAVA
    cfg = dataclasses.replace(get_config("llava-next-34b"),
                              n_layers=lv["layers"])
    kw = {k: lv[k] for k in ("batch", "prompt_len", "gen", "seed")}
    toks = S.serve(cfg, **kw)               # cuda:0, the entry point
    torch.cuda.empty_cache()
    (params, prompts, patches), draw_s = _synced(lambda: S.draw(
        cfg, batch=lv["batch"], prompt_len=lv["prompt_len"], seed=lv["seed"],
        device=dev))
    torch.cuda.reset_peak_memory_stats(dev)
    run = S.generate(params, prompts, cfg, gen=lv["gen"], frontend=patches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not np.array_equal(run["tokens"], toks) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("[encdec] llava: generate's tokens differ from "
                             "serve()'s, or leave the vocabulary")
    cache, _ = make_prefill_step(cfg, q_chunk=64)(
        params, {"tokens": prompts, "frontend": patches})
    want_pos = cfg.n_frontend_tokens + lv["prompt_len"]
    if cache["pos"] != want_pos:
        raise AssertionError(f"[encdec] llava: cache pos {cache['pos']} != "
                             f"{want_pos}")
    del cache
    text = torch.cat([prompts, torch.as_tensor(toks, device=dev)], 1)
    teacher = _teacher_forced(params, text, patches, cfg)
    n_params = sum(_numel(params))
    n_dec = lv["batch"] * (lv["gen"] - 1)
    out = {"layers": lv["layers"], "params": n_params, "draw_s": draw_s,
           "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
           "decode_tokens_per_s": n_dec / run["decode_s"],
           "peak_gb": peak_gb, "cache_pos": want_pos,
           "teacher_forced_err": teacher["max_abs_err"]}
    log(f"[encdec] llava-next-34b f32, {lv['layers']} of 60 layers "
        f"({n_params / 1e9:.3f} B params drawn in {draw_s:.3f} s), batch "
        f"{lv['batch']} x ({cfg.n_frontend_tokens} patches + "
        f"{lv['prompt_len']} tokens), {lv['gen']} greedy tokens: prefill "
        f"{run['prefill_s']:.4f} s, decode {out['decode_tokens_per_s']:.3f} "
        f"tokens/s ({run['decode_s']:.4f} s for {lv['gen'] - 1} steps), "
        f"peak {peak_gb:.3f} GB; cache pos {want_pos}; teacher-forced "
        f"decode of {teacher['positions']} positions: max_abs_err "
        f"{teacher['max_abs_err']:.3e} (tolerance {TEACHER_TOL:g}; max "
        f"|logit| {teacher['max_logit']:.3f}); card {card}")
    if not teacher["max_abs_err"] <= TEACHER_TOL:
        raise AssertionError(f"[encdec] llava: decode differs from forward "
                             f"by {teacher['max_abs_err']}")
    out["traced_decode_step"] = _traced_decode(
        params, prompts, patches, cfg, "encdec llava, traced decode step")
    del params, prompts, patches, run
    torch.cuda.empty_cache()
    return out


def encdec_phase(dev, card: str) -> dict:
    """[encdec]: whisper-tiny served and trained at full width and depth,
    llava-next-34b served at full width with 8 of 60 layers; the path
    reaches none of B1-B5."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    before = _b_launches()
    out = {"whisper_serve": _whisper_serve(dev, card)}
    gc.collect()
    out["whisper_train"] = _whisper_train(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["llava"] = _llava_serve(dev, card)
    if _b_launches() != before:
        raise AssertionError(f"[encdec] the path launched a B kernel: "
                             f"{before} -> {_b_launches()}")
    return out


# -- [pod]: sharding rules, production meshes, cell specs, the MoE over a mesh

POD_DECODE_SHAPE = "decode_32k"   # ep_decode's batch: 128 one-token rows
POD_SEQ = 512                     # TP/EP: one 512-token sequence a data shard
POD_TOL = 1e-4                    # max abs error / max |y|, TF32 off
H100_BYTES = 80e9                 # one H100's device memory


def _leaf_bytes(tree, shardings=None) -> int:
    """Bytes of a tree's tensors: global, or per device under the
    matching tree of ``NamedSharding`` (the cache's host ``pos`` and the
    decode cell's empty generator slot hold none)."""
    import torch
    import torch.utils._pytree as pytree

    leaves = pytree.tree_leaves(tree, is_leaf=lambda x: x is None)
    if shardings is None:
        shards = [None] * len(leaves)
    else:
        shards = pytree.tree_leaves(shardings, is_leaf=lambda x: x is None)
    total = 0
    for leaf, sh in zip(leaves, shards):
        if isinstance(leaf, torch.Tensor):
            shape = leaf.shape if sh is None else sh.shard_shape(leaf.shape)
            total += math.prod(shape) * leaf.element_size()
    return total


def _pod_cells(dev) -> dict:
    """(a) Every registry config x ``SHAPES`` cell on both production
    meshes (``cuda:0`` at every entry): ``input_specs``, the input and
    output shardings, per-device bytes of the inputs, and whether the
    cell's inputs (for a train cell, the train state and batch) fit one
    H100 whole."""
    from repro_torch.configs import SHAPES, all_configs
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_production_mesh

    meshes = {"16x16": make_production_mesh(),
              "2x16x16": make_production_mesh(multi_pod=True)}
    for mesh in meshes.values():
        if set(mesh.devices.flat) != {dev}:
            raise AssertionError(f"[pod] production mesh off {dev}: {mesh}")
    cells, too_big = {}, []
    for arch, cfg in sorted(all_configs().items()):
        for name, shape in SHAPES.items():
            args = SP.input_specs(cfg, shape)
            whole = _leaf_bytes(args)
            row = {"bytes": whole, "fits_h100": whole <= H100_BYTES}
            for tag, mesh in meshes.items():
                ins = SP.input_shardings(cfg, shape, mesh, args)
                outs = SP.output_shardings(cfg, shape, mesh, args)
                if len(ins) != len(args) or not outs:
                    raise AssertionError(f"[pod] {arch} {name} {tag}: "
                                         f"shardings do not match the args")
                row[f"per_device_bytes_{tag}"] = _leaf_bytes(args, ins)
                row[f"microbatches_{tag}"] = SP.default_microbatches(
                    cfg, shape, mesh)
            cells[f"{arch}/{name}"] = row
            if not row["fits_h100"]:
                too_big.append(f"{arch}/{name}")
            log(f"[pod] {arch} {name} ({shape.kind}): inputs "
                f"{whole / 1e9:.3f} GB whole"
                f"{'' if row['fits_h100'] else ' (over one H100)'}, per "
                f"device {row['per_device_bytes_16x16'] / 1e9:.6f} GB on "
                f"16x16, {row['per_device_bytes_2x16x16'] / 1e9:.6f} GB on "
                f"2x16x16; microbatches {row['microbatches_16x16']} / "
                f"{row['microbatches_2x16x16']}")
    train = [c for c in cells if c.endswith("/train_4k")]
    log(f"[pod] {len(cells)} cells x 2 meshes; train states over one "
        f"H100's {H100_BYTES / 1e9:g} GB: "
        f"{', '.join(c for c in train if c in too_big) or 'none'}; every "
        f"cell over it: {', '.join(too_big) or 'none'}")
    return {"cells": cells, "over_one_h100": too_big}


def _moe_run(tag: str, fn, want_y, want_aux, dev, counted=None) -> dict:
    """One mesh function's run against its target: max abs error over max
    |y|, the aux loss, wall seconds, peak memory, and the shards the body
    ran on (``counted``: a list the patched body appends to)."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    (y, aux), wall = _synced(fn)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    scale = float(want_y.abs().max())
    err = float((y - want_y).abs().max())
    aux_err = abs(float(aux) - float(want_aux))
    out = {"max_abs_err": err, "max_abs_y": scale, "rel_err": err / scale,
           "aux": float(aux), "aux_err": aux_err, "wall_s": wall,
           "peak_gb": peak, "shards": None if counted is None
           else len(counted)}
    log(f"[pod] dbrx-132b MoE layer, {tag}: max_abs_err {err:.3e} (max |y| "
        f"{scale:.4f}, ratio {err / scale:.3e}, tolerance {POD_TOL:g}); aux "
        f"{float(aux):.6f} (off by {aux_err:.3e}); wall {wall:.4f} s; peak "
        f"{peak:.3f} GB; body ran on {out['shards']} shards")
    if not (torch.isfinite(y).all() and err <= POD_TOL * scale
            and aux_err <= POD_TOL * abs(float(want_aux))):
        raise AssertionError(f"[pod] {tag}: {out}")
    return out


def _global_aux(x, p, moe):
    """The load-balance loss over every token: what the mesh functions'
    psum of the aux sums over the data axes gives."""
    from repro_torch.models import moe as M

    B, T, D = x.shape
    _, _, (me, ce, cnt) = M.router_topk(x.reshape(B * T, D), p["router"],
                                        moe)
    return moe.n_experts * (me / cnt * ce / cnt).sum()


def _pod_moe(dev) -> dict:
    """(b) DBRX-132B's MoE layer at full width in f32 (E=16, top-4,
    D=6144, F=10752; 12.7 GB of experts) on the production 16x16 mesh,
    single-process binding: 256 shards share the card.  ``moe_ffn`` under
    ``MOE_MODE="ep_decode"`` on decode_32k's 128 one-token rows,
    ``moe_ffn`` (TP) and ``moe_ep_ffn`` on 16 x 512 tokens, each against
    ``moe_ffn_local`` on the card per data shard."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TF
    from repro_torch.sharding import rules as R

    cfg = get_config("dbrx-132b")
    moe, D, Fd = cfg.moe, cfg.d_model, cfg.d_ff
    mesh = make_production_mesh()
    n_data = mesh.shape["data"]
    gen = torch.Generator(dev).manual_seed(0)
    torch.cuda.empty_cache()
    (p, _), draw_s = _synced(lambda: (M.init_moe_params(
        D, Fd, moe, generator=gen, device=dev), None))
    expert_gb = sum(p[k].numel() * 4 for k in ("w1", "w2", "w3")) / 1e9
    B_dec = SHAPES[POD_DECODE_SHAPE].global_batch
    x_dec = torch.randn(B_dec, 1, D, generator=gen, device=dev)
    x_seq = torch.randn(n_data, POD_SEQ, D, generator=gen, device=dev)
    log(f"[pod] dbrx-132b MoE layer f32: {expert_gb:.3f} GB of experts "
        f"drawn in {draw_s:.3f} s; mesh {mesh.shape} on {dev}")

    # the rules place DBRX's experts as moe_ffn_decode_ep reads them
    mode0 = M.MOE_MODE
    M.MOE_MODE = "ep_decode"
    try:
        specs = R.param_specs(cfg, mesh, TF.abstract_params(cfg))
        ffn = specs["blocks"][TF.slot_name(0, "attn")]["ffn"]
        got = {k: tuple(ffn[k])[1:]
               for k in ("w1", "w3", "w2")}
        want = {"w1": ("model", None, "data"), "w3": ("model", None, "data"),
                "w2": ("model", "data", None)}
        if got != want:
            raise AssertionError(f"[pod] ep_decode expert specs {got}")
        calls, body = [], M._ep_decode_local
        M._ep_decode_local = lambda *a, **k: (calls.append(1),
                                              body(*a, **k))[1]
        with torch.no_grad():
            want_y, want_aux = M.moe_ffn_local(x_dec, p, moe)
            out = {"ep_decode": _moe_run(
                f"moe_ffn (MOE_MODE ep_decode -> moe_ffn_decode_ep), "
                f"[{B_dec}, 1, {D}]", lambda: M.moe_ffn(x_dec, p, moe, mesh),
                want_y, want_aux, dev, calls)}
    finally:
        M.MOE_MODE, M._ep_decode_local = mode0, body

    with torch.no_grad():
        want_y = torch.cat([M.moe_ffn_local(xb, p, moe)[0]
                            for xb in x_seq.chunk(n_data)])
        want_aux = _global_aux(x_seq, p, moe)
        calls, body = [], M._moe_local
        M._moe_local = lambda *a, **k: (calls.append(1), body(*a, **k))[1]
        try:
            out["tp"] = _moe_run(
                f"moe_ffn (TP), [{n_data}, {POD_SEQ}, {D}]",
                lambda: M.moe_ffn(x_seq, p, moe, mesh), want_y, want_aux,
                dev, calls)
        finally:
            M._moe_local = body
        calls, body = [], M.moe_ep_ffn_local
        M.moe_ep_ffn_local = lambda *a, **k: (calls.append(1),
                                              body(*a, **k))[1]
        try:
            out["ep"] = _moe_run(
                f"moe_ep_ffn, [{n_data}, {POD_SEQ}, {D}]",
                lambda: M.moe_ep_ffn(x_seq, p, moe, mesh), want_y, want_aux,
                dev, calls)
        finally:
            M.moe_ep_ffn_local = body
    for run in out.values():
        if run["shards"] != mesh.size:
            raise AssertionError(f"[pod] a body ran on {run['shards']} of "
                                 f"{mesh.size} shards")
    del p, x_dec, x_seq, want_y
    torch.cuda.empty_cache()
    return {"experts_gb": expert_gb, **out}


def pod_phase(dev, card: str) -> dict:
    """[pod]: the placement half of the pod tooling on cuda:0; it reaches
    none of B1-B5."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    before = _b_launches()
    out = {"specs": _pod_cells(dev), "moe": _pod_moe(dev), "card": card}
    if _b_launches() != before:
        raise AssertionError(f"[pod] the path launched a B kernel: "
                             f"{before} -> {_b_launches()}")
    return out


# -- [dryrun]: the dry run over fake 256/512-rank groups, held to the card
# full-size cells, each dry-run on both production meshes, (arch, shape,
# microbatches: None for the cell's default); DBRX's train record at its
# default (16 on 16x16) alone took 193-267 s of the phase's wall
DRYRUN_CELLS = (("dbrx-132b", "decode_32k", None),
                ("dbrx-132b", "train_4k", 2),
                ("qwen3-8b", "prefill_32k", None),
                ("rwkv6-1.6b", "long_500k", None))
DRYRUN_TIMEOUT_S = 600
# the check on the card: qwen3-8b at full width with 4 of its 36 layers in
# bf16 (~2 B parameters: its f32 AdamW state fits one card), a prefill of
# 1 x 8192 and a train step of 1 x 4096 in 1 microbatch, (seq, batch, reps)
DRYRUN_CHECK_LAYERS = 4
DRYRUN_CHECK = {"prefill": (8192, 1, 5), "train": (4096, 1, 3)}
DRYRUN_MEM_TOL = 0.10
_DRYRUN_WORKER = r"""
import json, sys
sys.path.insert(0, "src")
from repro_torch.launch.dryrun import dryrun_cell
rec = dryrun_cell(sys.argv[1], sys.argv[2], multi_pod=sys.argv[3] == "1",
                  microbatches=json.loads(sys.argv[4]), verbose=False)
print("RECORD " + json.dumps(rec))
"""


def _dryrun_records() -> list:
    """``DRYRUN_CELLS`` on both production meshes, one child process a
    record, all started together; the card is hidden from them (the dry
    run runs on no device)."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    procs = [((arch, shape, mp), subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_WORKER, arch, shape, str(mp),
         json.dumps(mb)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT))) for arch, shape, mb in DRYRUN_CELLS for mp in (0, 1)]
    records = []
    try:
        for cell, proc in procs:
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"[dryrun] {cell}: exit "
                                     f"{proc.returncode}: {err[-3000:]}")
            rec = json.loads(next(ln for ln in out.splitlines()
                                  if ln.startswith("RECORD "))[7:])
            if rec["status"] != "ok":
                raise AssertionError(f"[dryrun] {cell}: {rec}")
            records.append(rec)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return records


def _log_record(rec: dict):
    from repro_torch.launch.dryrun import HBM_BYTES

    m = rec["memory"]
    log(f"[dryrun] {rec['arch']} x {rec['shape']} "
        f"{'2x16x16' if rec['multi_pod'] else '16x16'}: "
        f"{m['per_device_total'] / 1e9:.3f} GB a device (fits "
        f"{HBM_BYTES / 2**30:.1f} GiB: {rec['fits_hbm']}), flops "
        f"{rec['hlo_flops_raw']:.4e}, bytes {rec['hlo_bytes_raw']:.4e}, "
        f"collective bytes {json.dumps(rec['collectives']['by_op'])} over "
        f"{rec['collectives']['count']}, run {rec['lower_s']} s")
    for line in rec["schedule"][:3]:
        log(f"[dryrun]   {line}")


def _dryrun_check(dev, card: str, kind: str) -> dict:
    """qwen3-8b with ``DRYRUN_CHECK_LAYERS`` layers: the dry run on a 1x1
    mesh, then the same step for real on the card with plain tensors:
    predicted per-device total against the peak the step allocates, the
    dry run's flops against ``FlopCounterMode`` on the card's run, and
    the step's median time against its bound."""
    import dataclasses
    import gc
    import statistics

    import torch
    import torch.utils._pytree as pytree
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_region_mesh
    from repro_torch.models import lm as LM
    from repro_torch.models import transformer as TF

    cfg = dataclasses.replace(get_config("qwen3-8b"),
                              n_layers=DRYRUN_CHECK_LAYERS)
    seq, batch, reps = DRYRUN_CHECK[kind]
    shape = ShapeConfig(f"{kind}_check", seq, batch, kind)
    mb = 1 if kind == "train" else None
    rec = D.dryrun_step(cfg, shape, make_region_mesh([["cpu"]]),
                        microbatches=mb)

    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                           device=dev, dtype=torch.int32)
    if kind == "train":
        first = LM.init_train_state(cfg, S.cell_opt(cfg), generator=g,
                                    device=dev, param_dtype=torch.bfloat16)
        labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                               device=dev, dtype=torch.int32)
        args = (first, {"tokens": tokens, "labels": labels})
    else:
        params = TF.init_params(cfg, generator=g, device=dev,
                                dtype=torch.bfloat16)
        args = (params, {"tokens": tokens})
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in pytree.tree_leaves(args)
                    if isinstance(t, torch.Tensor))
    fn = S.step_fn(cfg, shape, make_region_mesh([[dev]]), remat="2level",
                   microbatches=mb)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    # the step's own footprint: its arguments and what it allocates
    measured = peak - before + arg_bytes
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        del out
    del args
    gc.collect()
    torch.cuda.empty_cache()

    predicted = rec["memory"]["per_device_total"]
    flops = rec["hlo_flops_raw"]
    t_flops = flops / D.PEAK_FLOPS_BF16 * 1e3
    t_bytes = rec["hlo_bytes_raw"] / D.HBM_BW * 1e3
    bound = max(t_flops, t_bytes)
    ms = statistics.median(times)
    res = {"kind": kind, "seq": seq, "batch": batch,
           "layers": DRYRUN_CHECK_LAYERS,
           "predicted_bytes": predicted, "measured_bytes": measured,
           "max_memory_allocated": peak, "allocated_before": before,
           "argument_bytes": arg_bytes,
           "mem_ratio": predicted / measured,
           "dry_flops": flops, "card_flops": fc.get_total_flops(),
           "dry_bytes": rec["hlo_bytes_raw"], "step_ms": ms,
           "step_ms_all": times, "bound_ms": bound,
           "bound_by": "operations" if t_flops >= t_bytes else "bytes",
           "step_over_bound": ms / bound, "card": card}
    log(f"[dryrun] check qwen3-8b {DRYRUN_CHECK_LAYERS} layers {kind} "
        f"{batch} x {seq} bf16 on {card}: predicted {predicted / 1e9:.3f} "
        f"GB a device, the step's peak {measured / 1e9:.3f} GB "
        f"(max_memory_allocated {peak / 1e9:.3f} GB, allocated before "
        f"{before / 1e9:.3f} GB, arguments {arg_bytes / 1e9:.3f} GB); "
        f"flops dry {flops:.6e} card {res['card_flops']:.6e}; step "
        f"{ms:.3f} ms (median of {reps}) against a bound of {bound:.3f} ms "
        f"({res['bound_by']}): {res['step_over_bound']:.3f}x")
    if abs(predicted / measured - 1) > DRYRUN_MEM_TOL:
        raise AssertionError(f"[dryrun] {kind}: predicted {predicted} "
                             f"against {measured} bytes")
    if res["card_flops"] != flops:
        raise AssertionError(f"[dryrun] {kind}: dry-run flops {flops} "
                             f"against {res['card_flops']} on the card")
    return res


def dryrun_phase(dev, card: str) -> dict:
    """[dryrun]: the analysis half of the pod tooling.  The full-size
    cells' dry runs (no device), then the check on the card; it reaches
    none of B1-B5."""
    before = _b_launches()
    t0 = time.perf_counter()
    records = _dryrun_records()
    wall = time.perf_counter() - t0
    for rec in records:
        _log_record(rec)
    log(f"[dryrun] {len(records)} records ok, {wall:.3f} s wall in "
        f"{len(records)} processes at once")
    checks = [_dryrun_check(dev, card, kind) for kind in DRYRUN_CHECK]
    if _b_launches() != before:
        raise AssertionError(f"[dryrun] the path launched a B kernel: "
                             f"{before} -> {_b_launches()}")
    return {"records": [{k: r[k] for k in ("arch", "shape", "multi_pod",
                                           "status", "fits_hbm", "memory",
                                           "hlo_flops_raw", "hlo_bytes_raw",
                                           "collectives", "lower_s")}
                        for r in records],
            "records_wall_s": wall, "checks": checks}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.controller.kernels import get_kernel
    from repro_torch.core.context import ContextRecord
    from repro_torch.core.preemption import run_to_completion
    from repro_torch.kernels import native
    from repro_torch.kernels.blur import kernel as K
    from repro_torch.kernels.blur import ref as R
    from repro_torch.kernels.blur.tasks import ROW_BLOCK, make_image

    # TF32 would change what conv2d computes; the yardstick stays f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(0)

    # 1. card -------------------------------------------------------------
    card = card_line()
    log(f"[card] {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    native.load_libraries(LIBRARIES)
    log(f"[build] {', '.join(n + '.cu' for n in LIBRARIES)} in parallel: "
        f"{time.perf_counter() - t0:.3f} s")
    for lib in LIBRARIES:
        info = native.build_info[lib]
        log(f"[build] {lib}.cu -> {info['path']} ({info['seconds']:.3f} s)")
        for line in info["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"[build] {lib}: {line.strip()}")

    # 3. kernel vs plain version --------------------------------------------
    errs = {"median": 0.0, "gaussian": 0.0}
    for n_blocks, w in BLUR_CHECKS:
        block = torch.tensor(rng.random((n_blocks * ROW_BLOCK + 2, w + 2),
                                        dtype=np.float32), device=dev)
        for kind in ("median", "gaussian"):
            got = K.blur_block(block, kind)
            torch.cuda.synchronize()
            err = check(kind, got, R.blur_block(block, kind))
            errs[kind] = max(errs[kind], err)
            per_thread = K.rows_per_thread(n_blocks * ROW_BLOCK, w)
            log(f"[check] {kind} [{n_blocks * ROW_BLOCK + 2}, {w + 2}] "
                f"({n_blocks} row block(s), {per_thread} rows a thread) "
                f"max_abs_err {err:.3e}")
    img = make_image(rng, SIZE)
    kd = get_kernel("MedianBlur")
    bufs, ints, floats = kd.bundle(img, np.zeros_like(img), H=SIZE, W=SIZE,
                                   iters=BG_ITERS).padded()
    ctx, state, _ = run_to_completion(
        kd.fn, ContextRecord.fresh(), tuple(torch.tensor(b, device=dev)
                                            for b in bufs),
        ints, floats, budget=kd.default_budget)
    torch.cuda.synchronize()
    whole_err = check("median", state[BG_ITERS % 2],
                      R.iterated_blur_ref(torch.tensor(img, device=dev),
                                          BG_ITERS, "median"))
    log(f"[check] whole {BG_ITERS}-iteration median image {img.shape}: "
        f"max_abs_err {whole_err:.3e} (done={ctx.done})")
    del state

    # 4. main path ----------------------------------------------------------
    imgs = [make_image(rng, SIZE) for _ in range(3)]
    tasks, urgent, rep, main_s, (blocks, launches, _) = serve(imgs,
                                                             SLOWDOWN_S)
    n_rb = SIZE // ROW_BLOCK
    budget = get_kernel("MedianBlur").default_budget
    want_blocks = {"median": 2 * BG_ITERS * n_rb,
                   "gaussian": URGENT_ITERS * n_rb}
    log_serve("main", tasks, urgent, rep, main_s, SLOWDOWN_S)
    log(f"[main] row blocks {blocks} (expected exactly {want_blocks}); "
        f"launches {launches} (expected at least ceil(row blocks / "
        f"{budget}) a kind, at most 2 x {rep['chunks']} chunks retired)")
    if rep["preemptions"] < 1:
        raise AssertionError("the urgent task preempted nothing")
    if blocks != want_blocks:
        raise AssertionError(f"row-block count {blocks} != {want_blocks}")
    if (any(launches[k] < -(-blocks[k] // budget) for k in launches)
            or sum(launches.values()) > 2 * rep["chunks"]):
        raise AssertionError(f"launch count {launches} outside "
                             f"[ceil({blocks} / {budget}), 2 x "
                             f"{rep['chunks']} chunks]")
    for t, im, iters, kind in ((tasks[0], imgs[0], BG_ITERS, "median"),
                               (tasks[1], imgs[1], BG_ITERS, "median"),
                               (urgent, imgs[2], URGENT_ITERS, "gaussian")):
        err = _check_result(t, im, iters, dev)
        log(f"[main] task #{t.tid} {kind} x{iters}: preempted "
            f"{t.n_preemptions}x on regions {t.region_history}, max_abs_err "
            f"{err:.3e}")

    # 5. times ---------------------------------------------------------------
    src = torch.tensor(imgs[0], device=dev)
    dst = torch.zeros_like(src)
    run_rows = RUN_BLOCKS * ROW_BLOCK
    weight = torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]],
                          device=dev).div(16.0).view(1, 1, 3, 3)
    records = []
    for kind in ("median", "gaussian"):
        def launch_rows(n_blocks, kind=kind):
            return lambda: K.blur_rows(src, dst, 0, ROW_BLOCK, kind, n_blocks)

        def kernel_image(kind=kind):
            for r in range(0, n_rb, RUN_BLOCKS):
                K.blur_rows(src, dst, r * ROW_BLOCK, ROW_BLOCK, kind,
                            RUN_BLOCKS)

        def plain_run(kind=kind):
            dst[1:run_rows + 1, 1:SIZE + 1] = R.blur_block(
                src[:run_rows + 2], kind)

        arms = {"kernel, run": (launch_rows(RUN_BLOCKS), 1),
                "kernel, block": (launch_rows(1), 1),
                "kernel, image": (kernel_image, n_rb // RUN_BLOCKS),
                "plain, run": (plain_run, None)}
        if kind == "gaussian":
            arms["conv2d, run"] = (
                lambda: F.conv2d(src[None, None, :run_rows + 2], weight), None)
            conv_err = float((F.conv2d(src[None, None, :run_rows + 2],
                                       weight)[0, 0]
                              - K.blur_block(src[:run_rows + 2], kind))
                             .abs().max())
            log(f"[time] gaussian conv2d (TF32 off) max diff vs kernel "
                f"{conv_err:.3e}")
        dev_ms = {}
        for arm, (fn, n_launch) in arms.items():
            dev_ms[arm] = device_ms(fn, launches=n_launch)
            how = "device (torch.profiler)"
            if dev_ms[arm] <= 0.0:
                dev_ms[arm] = queued_ms(fn)
                how = "queued behind a spin kernel (the profiler missed it)"
            wall = cuda_time_ms(fn, reps=20)
            log(f"[time] {kind} {arm}: {dev_ms[arm]:.6f} ms {how}; wall "
                f"(CUDA events, back-to-back) {wall:.6f} ms")
        # every rows-per-thread instantiation at the run shape, through the
        # C entry (the wrapper always takes the plan's)
        run_src, run_dst = src[:run_rows + 2], dst[1:run_rows + 1, 1:SIZE + 1]
        vec = int(run_src.data_ptr() % 8 == 0 and run_src.stride(0) % 2 == 0)
        for per_thread in K.ROWS_PER_THREAD:
            def fn(per_thread=per_thread, kind=kind):
                err = K._lib()(run_src.data_ptr(), run_src.stride(0),
                               run_dst.data_ptr(), run_dst.stride(0),
                               run_rows, SIZE, K.KINDS[kind], per_thread, vec,
                               torch.cuda.current_stream(dev).cuda_stream)
                if err != 0:
                    raise RuntimeError(f"blur_rows ({per_thread} rows a "
                                       f"thread) failed: CUDA error {err}")

            ms, how = device_ms(fn, launches=1), "device"
            if ms <= 0.0:
                ms, how = queued_ms(fn), "queued behind a spin kernel"
            plan = K.rows_per_thread(run_rows, SIZE)
            log(f"[time] {kind} run, {per_thread} rows a thread"
                f"{' (the plan)' if per_thread == plan else ''}: {ms:.6f} ms "
                f"per launch ({how})")
        per_block = {"run": dev_ms["kernel, run"] / RUN_BLOCKS,
                     "block": dev_ms["kernel, block"],
                     "image": dev_ms["kernel, image"] / n_rb}
        bounds = {}
        for what, rows in (("run", run_rows), ("block", ROW_BLOCK)):
            nbytes = ((rows + 2) * (SIZE + 2) + rows * SIZE) * 4
            bounds[what] = (nbytes / HBM_BYTES_PER_S * 1e3,
                            OPS_PER_PIXEL[kind] * rows * SIZE
                            / F32_OPS_PER_S * 1e3)
        log(f"[time] {kind}: per row block {per_block['run']:.6f} ms in a "
            f"{RUN_BLOCKS}-block run, {per_block['block']:.6f} ms alone, "
            f"{per_block['image']:.6f} ms over a whole image of "
            f"{n_rb // RUN_BLOCKS} runs ({dev_ms['kernel, image']:.6f} ms); "
            f"bound per launch {max(bounds['run']):.6f} ms at "
            f"[{run_rows + 2}, {SIZE + 2}], {max(bounds['block']):.6f} ms at "
            f"[{ROW_BLOCK + 2}, {SIZE + 2}] (bytes {bounds['run'][0]:.6f} / "
            f"{bounds['block'][0]:.6f}, operations {bounds['run'][1]:.6f} / "
            f"{bounds['block'][1]:.6f})")
        rec = {"name": f"blur_{kind}", "route": "cuda",
               "source": "src/repro_torch/csrc/blur.cu",
               "replaces": REPLACES[kind],
               "launches": launches[kind],
               "max_abs_err": errs[kind],
               "ms": dev_ms["kernel, run"],
               "row_blocks_per_launch": RUN_BLOCKS,
               "ms_per_row_block": per_block["run"],
               "plain_ms": dev_ms["plain, run"],
               "bound_ms": max(bounds["run"]),
               "bound_by": ("bytes" if bounds["run"][0] >= bounds["run"][1]
                            else "operations"),
               "library_ms": dev_ms.get("conv2d, run")}
        records.append(rec)
        log(f"[time] {kind}: kernel {rec['ms']:.6f} ms device per launch of "
            f"the main path ([{run_rows + 2}, {SIZE + 2}]); bound "
            f"{rec['bound_ms']:.6f} ms ({rec['bound_by']})")

    e2e = serve(imgs, 0.0)
    log_serve("e2e, no slowdown", *e2e[:4], 0.0)
    # the copies every task pays outside its chunks: the fresh upload of its
    # two images and the result copy back, both from pageable host memory
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = [torch.as_tensor(b).to(dev, copy=True)
               for b in (imgs[0], np.zeros_like(imgs[0]))]
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _ = [b.cpu().numpy() for b in on_card]
    down_ms = (time.perf_counter() - t0) * 1e3
    mb = 2 * imgs[0].nbytes / 1e6
    log(f"[copies] one task's two images ({mb:.1f} MB, pageable host "
        f"memory): upload {up_ms:.3f} ms ({mb / up_ms:.3f} GB/s), result "
        f"copy {down_ms:.3f} ms ({mb / down_ms:.3f} GB/s); kernel device "
        f"time per 3-iteration task "
        f"{records[0]['ms'] * 3 * n_rb / RUN_BLOCKS:.3f} ms")

    # 5a-5c. the elastic pool, the Controller, the preemption overhead ------
    t0 = time.perf_counter()
    pool_phase(rng, dev)
    controller_phase(rng, dev)
    overhead = overhead_phase(OVERHEAD_SEED, dev)
    summary = {n: {k: v for k, v in o.items() if k != "runs"}
               for n, o in overhead.items()}
    log(f"[overhead] {json.dumps(summary)}")
    log(f"[pool+controller+overhead] {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    traced = trace_phase(imgs, dev)
    log(f"[trace] {json.dumps(traced)}")
    log(f"[trace] {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    records += mega_phase(rng, dev, imgs,
                          {r["name"][5:]: r["ms"] for r in records[:2]})
    log(f"[mega] {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    clustered = cluster_phase(rng, dev, imgs)
    log(f"[cluster] {json.dumps(clustered)}")
    log(f"[cluster] {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    decoded_records, decoded = decode_phase(dev)
    records += decoded_records
    log(f"[decode] {json.dumps(decoded)}")
    log(f"[decode] {time.perf_counter() - t0:.3f} s")

    records += attention_phases(dev, card)
    records += recurrent_phases(dev, card)
    t0 = time.perf_counter()
    trained = train_phase(dev, card)
    log(f"[train] {json.dumps(trained)}")
    log(f"[train] {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    encdec = encdec_phase(dev, card)
    log(f"[encdec] {json.dumps(encdec)}")
    log(f"[encdec] {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    pod = pod_phase(dev, card)
    log(f"[pod] {json.dumps(pod['moe'])}")
    log(f"[pod] {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    dry = dryrun_phase(dev, card)
    log(f"[dryrun] {json.dumps(dry['checks'])}")
    log(f"[dryrun] {time.perf_counter() - t0:.3f} s")

    log(f"[smoke] {time.perf_counter() - t_start:.3f} s in all")
    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


_AB_WORKER = r"""
import json, sys
tree, n_runs = sys.argv[1], int(sys.argv[2])
sys.path[:0] = [tree, tree + "/src"]
import numpy as np
import chip_smoke as cs
from repro_torch.kernels import native
from repro_torch.kernels.blur.tasks import make_image
assert cs.__file__.startswith(tree), cs.__file__
native.load_libraries(("blur",))
rng = np.random.default_rng(0)
imgs = [make_image(rng, cs.SIZE) for _ in range(3)]
runs = []
for i in range(n_runs + 1):             # the first run warms up
    tasks, urgent, rep, wall_s, _ = cs.serve(imgs, 0.0)
    if i:
        runs.append({
            "wall_ms": wall_s * 1e3,
            "host_ms_per_chunk": sum(t.run_s for t in (*tasks, urgent))
            / rep["chunks"] * 1e3,
            "urgent_service_ms": urgent.service_time * 1e3,
            "chunks": rep["chunks"], "preemptions": rep["preemptions"]})
print("AB " + json.dumps(runs))
"""


def ab_main(other: str) -> int:
    """``--ab OTHER_TREE``: the main path's untraced workload in another
    tree and in this one, one process each, other, this, this, other."""
    import os
    import statistics

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": str(Path(other).resolve()), "this": str(ROOT)}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log(f"[ab] {card_line()}; other = {trees['other']}, this = "
        f"{trees['this']}; {AB_RUNS} runs an arm after a warm-up")
    runs = {"other": [], "this": []}
    for arm in ("other", "this", "this", "other"):
        out = subprocess.run(
            [sys.executable, "-c", _AB_WORKER, trees[arm], str(AB_RUNS)],
            capture_output=True, text=True, env=env, cwd=trees[arm],
            timeout=TIMEOUT_S * 2)
        if out.returncode != 0:
            raise AssertionError(f"[ab] {arm}: exit {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        got = json.loads(next(ln for ln in out.stdout.splitlines()
                              if ln.startswith("AB "))[3:])
        runs[arm] += got
        for r in got:
            log(f"[ab] {arm}: {json.dumps(r)}")
    for arm, rs in runs.items():
        for key in ("host_ms_per_chunk", "urgent_service_ms", "wall_ms"):
            xs = [r[key] for r in rs]
            log(f"[ab] {arm} {key}: median {statistics.median(xs):.4f}, "
                f"range {min(xs):.4f}-{max(xs):.4f} over {len(xs)} runs")
    return 0


_AB_ATTN_WORKER = r"""
import json, sys
tree, n_runs = sys.argv[1], int(sys.argv[2])
import numpy as np
import torch
import chip_smoke as cs                 # this tree's inputs and timers
sys.path.insert(0, tree + "/src")       # the tree's kernels, ahead of ours
from repro_torch.kernels import native
from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.decode_attention import ref as DR
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.core.context import ContextRecord
from repro_torch.core.preemption import PreemptFlag
from repro_torch.kernels.attn_lm import kernel as AK
from repro_torch.serving import attention as A
assert FK.__file__.startswith(tree) and DK.__file__.startswith(tree)
assert AK.__file__.startswith(tree)
libs = ("flash_attention", "decode_attention", "attn_lm")
native.load_libraries(libs)
build = {n: [ln.strip() for ln in native.build_info[n]["log"].splitlines()
             if "registers" in ln or "spill" in ln] for n in libs}
dev = torch.device("cuda", 0)
rng = np.random.default_rng(1)
H, KV, hd, BS = (cs.SERVING[k] for k in ("attn_heads", "attn_kv_heads",
                                         "attn_head_dim", "kv_block_size"))
PB, C, S, B = (cs.SERVING[k] for k in ("prefill_batch", "kv_block_size",
                                       "max_ctx", "max_slots"))
scale = 1.0 / hd ** 0.5
randn = lambda *sh: torch.tensor(rng.standard_normal(sh, dtype=np.float32),
                                 device=dev)
q = randn(PB, C, H, hd).transpose(1, 2)
k, v = (randn(PB, S, KV, hd).transpose(1, 2) for _ in range(2))
T_blk = S // BS
NB = B * T_blk + 1
k_pool, v_pool = randn(NB, BS, KV, hd), randn(NB, BS, KV, hd)
tables = torch.tensor(rng.permutation(np.arange(1, NB)).reshape(
    B, T_blk).astype(np.int32), device=dev)
qs = randn(B, H, 1, hd)
pos = torch.tensor([0, 1, 17, 40, 64, 100, 127, 128], dtype=torch.int32,
                   device=dev)
flash = lambda: [FK.launch(q, k, v, causal=True, window=None, q_offset=o,
                           scale=scale) for o in range(0, S, C)]
decode = lambda: DK.launch_paged(qs, k_pool, v_pool, tables, pos,
                                 window=None, scale=scale)
err = {"flash_attention": max(float((got - FR.flash_attention(
           q, k, v, causal=True, q_offset=o, scale=scale)).abs().max())
           for o, got in zip(range(0, S, C), flash())),
       "decode_attention": float((decode() - DR.paged_decode_attention(
           qs, k_pool, v_pool, tables, pos, scale=scale)).abs().max())}
# M4 and M5 at [serve, mega]'s widths, shapes and budget, on seeded weights
# drawn on the card (build_weights' scales): a whole task a launch, held
# against the plain version once
p = A.AttentionParams(
    d_model=cs.SERVING["d_model"], vocab=cs.SERVING["vocab_size"],
    n_heads=H, kv_heads=KV, head_dim=hd, block_size=BS, max_ctx=S,
    seed=cs.SERVING["weights_seed"])
_, pe0, q0, _, _, _, rows = A._row_offsets(p)
gen = torch.Generator(device=dev).manual_seed(p.seed)
weights = torch.randn((rows, p.d_model), generator=gen, device=dev)
weights[pe0:q0] *= 0.5
weights[q0:] *= 1.0 / p.d_model ** 0.5
flag, fresh = PreemptFlag(dev), ContextRecord.fresh()
B0 = cs.SERVE_CHUNK_BUDGET
one, four = cs.ATTN_EMIT_LENS  # rows emitting in one chunk, in four
mega = {}
for kind, name, budget, lens in (
        ("prefill", "attn_prefill_mega", B0, None),
        ("prefill", "attn_prefill_mega/one_chunk", B0, one),
        ("prefill", "attn_prefill_mega/four_chunks", B0, four),
        ("prefill", "attn_prefill_mega/four_chunks/budget_8", 8, four),
        ("decode", "attn_decode_mega", B0, None)):
    mine, plain, sc = cs._attn_buffers(kind, dev, rng, weights, p, lens=lens)
    saved = [b.clone() for b in mine[:-1]]
    _, err[name] = cs._attn_step(kind, mine, plain, sc, p, fresh, budget,
                                 flag, 0)
    for a, b in zip(mine[:-1], saved):
        a.copy_(b)
    mega[name] = (lambda kind=kind, mine=mine, budget=budget: cs._attn_launch(
        kind, fresh.to_words(), mine, p, budget, flag).result())
runs = []
for _ in range(n_runs):
    r = {"flash_attention": {"profiler": cs.device_ms(flash, launches=S // C)
                             / (S // C),
                             "queued": cs.queued_ms(flash) / (S // C)},
         "decode_attention": {"profiler": cs.device_ms(decode, launches=1),
                              "queued": cs.queued_ms(decode)}}
    for name, fn in mega.items():
        r[name] = {"profiler": cs._named_ms(fn, "attn_mega_kernel", 1)}
        if "/" not in name:
            r[name]["events"] = cs.cuda_time_ms(fn, reps=5, warmup=1)
    runs.append(r)
print("AB " + json.dumps({"build": build, "err": err, "runs": runs}))
"""


def ab_attention_main(other: str) -> int:
    """``--ab-attention OTHER_TREE``: B2's and B3's device time per launch
    at phase 9's shapes (8 prefill segments, q [4, 32, 16, 128]; a paged
    decode of 8 rows over pools [65, 16, 8, 128]), and M4's and M5's a
    launch at ``[serve, mega]``'s widths and budget (M4 also at the prompts
    of ``ATTN_EMIT_LENS``, and at budget 8), with another tree's kernels
    and with this tree's, one process each, other, this, this, other;
    every process builds its tree's sources, checks the kernels against
    their plain versions and logs the ptxas register and spill lines.  The
    inputs and timers are this script's."""
    import os
    import statistics

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": str(Path(other).resolve()), "this": str(ROOT)}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log(f"[ab-attention] {card_line()}; other = {trees['other']}, this = "
        f"{trees['this']}; {AB_RUNS} timings a kernel a process")
    got = {"other": [], "this": []}
    for arm in ("other", "this", "this", "other"):
        out = subprocess.run(
            [sys.executable, "-c", _AB_ATTN_WORKER, trees[arm],
             str(AB_RUNS)], capture_output=True, text=True, env=env,
            cwd=str(ROOT), timeout=TIMEOUT_S)
        if out.returncode != 0:
            raise AssertionError(f"[ab-attention] {arm}: exit "
                                 f"{out.returncode}: {out.stderr[-3000:]}")
        res = json.loads(next(ln for ln in out.stdout.splitlines()
                              if ln.startswith("AB "))[3:])
        for name, lines in res["build"].items():
            for line in lines:
                log(f"[ab-attention] {arm} {name} build: {line}")
        log(f"[ab-attention] {arm}: max abs error against the plain "
            f"versions {res['err']}")
        if not max(res["err"].values()) <= F32_TOL:
            raise AssertionError(f"[ab-attention] {arm}: {res['err']}")
        for r in res["runs"]:
            log(f"[ab-attention] {arm}: {json.dumps(r)}")
        got[arm] += res["runs"]
    for name, hows in (("flash_attention", ("profiler", "queued")),
                       ("decode_attention", ("profiler", "queued")),
                       ("attn_prefill_mega", ("profiler", "events")),
                       ("attn_prefill_mega/one_chunk", ("profiler",)),
                       ("attn_prefill_mega/four_chunks", ("profiler",)),
                       ("attn_prefill_mega/four_chunks/budget_8",
                        ("profiler",)),
                       ("attn_decode_mega", ("profiler", "events"))):
        for how in hows:
            for arm, rs in got.items():
                xs = [r[name][how] * 1e3 for r in rs if r[name][how] > 0]
                if xs:
                    log(f"[ab-attention] {name} {how} {arm}: median "
                        f"{statistics.median(xs):.4f} us a launch, range "
                        f"{min(xs):.4f}-{max(xs):.4f} over {len(xs)}")
    return 0


_AB_SEQ_WORKER = r"""
import json, sys
tree, n_runs = sys.argv[1], int(sys.argv[2])
import numpy as np
import torch
import chip_smoke as cs                 # this tree's inputs and timers
sys.path.insert(0, tree + "/src")       # the tree's kernels, ahead of ours
from repro_torch.kernels import native
from repro_torch.kernels.seq_lm import kernel as QK
from repro_torch.core.context import ContextRecord
from repro_torch.core.preemption import PreemptFlag
assert QK.__file__.startswith(tree)
native.load_libraries(("seq_lm", "preempt_flag"))
build = [ln.strip() for ln in native.build_info["seq_lm"]["log"].splitlines()
         if "registers" in ln or "spill" in ln]
dev = torch.device("cuda", 0)
rng = np.random.default_rng(32)
d, v = cs.SURROGATE["d_model"], cs.SURROGATE["vocab"]
flag, fresh = PreemptFlag(dev), ContextRecord.fresh()
cases, err = {}, {}
for kernel, name, shape in (
        ("SeqPrefill", "seq_prefill_mega",
         dict(prompt_len=cs.DECODE_MAIN["prompt_len"])),
        ("SeqDecode", "seq_decode_mega",
         dict(slots=cs.DECODE_MAIN["slots"],
              steps=cs.DECODE_MAIN["round_tokens"]))):
    for budget in cs.SEQ_TIME_BUDGETS:
        key = f"{name}/budget_{budget}"
        mine, plain, sc = cs._seq_buffers(kernel, dev, rng, d, v, **shape)
        saved = [b.clone() for b in mine]
        # a whole task against the plain version, bitwise (raises if not)
        _, err[key] = cs._seq_step(kernel, mine, plain, sc, fresh, budget,
                                   flag, 0)
        for a, b in zip(mine, saved):
            a.copy_(b)
        cases[key] = (lambda kernel=kernel, mine=mine, sc=sc, budget=budget:
                      cs._seq_launch(kernel, fresh.to_words(), mine, sc,
                                     budget, flag).result())
runs = []
for _ in range(n_runs):
    runs.append({k: {"profiler": cs._named_ms(fn, "seq_mega_kernel", 1)}
                 for k, fn in cases.items()})
# [decode]'s A/B workload in megakernel mode without probes, through the
# tree's serve_decode (every stream checked against the oracle inside it):
# a warm-up, then SEQ_AB_DECODE_RUNS timed runs
from repro_torch.launch.serve import serve_decode
decode = []
for i in range(cs.SEQ_AB_DECODE_RUNS + 1):
    rep = serve_decode(engine="megakernel", preempt_every=0, quiet=True,
                       **dict(cs.DECODE_MAIN, **cs.SURROGATE))
    if i:
        decode.append({k: rep[k] for k in ("tokens_per_s", "ttft_p50_s",
                                           "ttft_p99_s")})
print("AB " + json.dumps({"build": build, "err": err, "runs": runs,
                          "decode": decode}))
"""


def ab_seq_main(other: str) -> int:
    """``--ab-seq OTHER_TREE``: M2's and M3's device time per launch at
    ``[decode]``'s shapes (a 128-token prompt; 32 slots, an 8-token round)
    at ``SEQ_TIME_BUDGETS``, with another tree's kernels and with this
    tree's, one process each, other, this, this, other; every process
    builds its tree's ``seq_lm``, holds each case's whole task against the
    plain version bitwise and logs the ptxas register and spill lines.
    The inputs and timers are this script's."""
    import os
    import statistics

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": str(Path(other).resolve()), "this": str(ROOT)}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log(f"[ab-seq] {card_line()}; other = {trees['other']}, this = "
        f"{trees['this']}; {AB_RUNS} timings a case a process")
    got = {"other": [], "this": []}
    decode = {"other": [], "this": []}
    for arm in ("other", "this", "this", "other"):
        out = subprocess.run(
            [sys.executable, "-c", _AB_SEQ_WORKER, trees[arm], str(AB_RUNS)],
            capture_output=True, text=True, env=env, cwd=str(ROOT),
            timeout=TIMEOUT_S)
        if out.returncode != 0:
            raise AssertionError(f"[ab-seq] {arm}: exit {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        res = json.loads(next(ln for ln in out.stdout.splitlines()
                              if ln.startswith("AB "))[3:])
        for line in res["build"]:
            log(f"[ab-seq] {arm} seq_lm build: {line}")
        log(f"[ab-seq] {arm}: max abs difference from the plain version "
            f"{res['err']}")
        if max(res["err"].values()) != 0:
            raise AssertionError(f"[ab-seq] {arm}: {res['err']}")
        for r in res["runs"]:
            log(f"[ab-seq] {arm}: {json.dumps(r)}")
        for r in res["decode"]:
            log(f"[ab-seq] {arm} serve decode, megakernel, no probes: "
                f"{json.dumps(r)}")
        got[arm] += res["runs"]
        decode[arm] += res["decode"]
    for name in got["this"][0]:
        chunks = (DECODE_MAIN["prompt_len"] if "prefill" in name
                  else DECODE_MAIN["round_tokens"])
        budget = int(name.rsplit("_", 1)[1])
        for arm, rs in got.items():
            xs = [r[name]["profiler"] * 1e3 for r in rs
                  if r[name]["profiler"] > 0]
            if xs:
                med = statistics.median(xs)
                log(f"[ab-seq] {name} profiler {arm}: median {med:.4f} us a "
                    f"launch ({med / -(-chunks // budget):.4f} us a chunk), "
                    f"range {min(xs):.4f}-{max(xs):.4f} over {len(xs)}")
    for arm, rs in decode.items():
        tps = [r["tokens_per_s"] for r in rs]
        log(f"[ab-seq] serve decode megakernel {arm}: tok/s "
            f"{[round(x, 3) for x in tps]} (range {min(tps):.3f}-"
            f"{max(tps):.3f}), TTFT p50 "
            f"{[round(r['ttft_p50_s'] * 1e3, 3) for r in rs]} ms")
    return 0


_AB_MEGA_WORKER = r"""
import json, sys
tree, n_runs = sys.argv[1], int(sys.argv[2])
import numpy as np
import torch
import chip_smoke as cs                 # this tree's inputs and timers
sys.path.insert(0, tree + "/src")       # the tree's kernels, ahead of ours
from repro_torch.kernels import native
from repro_torch.kernels.blur import kernel as K
from repro_torch.kernels.blur.tasks import KERNELS, ROW_BLOCK, make_image
from repro_torch.kernels.blur.tasks import task_ints
from repro_torch.controller.kernels import get_kernel
from repro_torch.core.context import ContextRecord
from repro_torch.core.preemption import PreemptFlag, make_megakernel
assert K.__file__.startswith(tree)
native.load_libraries(("blur", "preempt_flag"))
build = [ln.strip() for ln in native.build_info["blur"]["log"].splitlines()
         if "registers" in ln or "spill" in ln]
dev = torch.device("cuda", 0)
rng = np.random.default_rng(0)
imgs = [make_image(rng, cs.SIZE) for _ in range(3)]
flag, fresh = PreemptFlag(dev), ContextRecord.fresh()
ints = task_ints(cs.SIZE, cs.SIZE, cs.BG_ITERS)
mine, plain = cs._mega_images(dev, imgs[1])
cases, err = {}, {}
for kind in ("median", "gaussian"):
    for budget in cs.MEGA_TIME_BUDGETS:
        key = f"{kind}/budget_{budget}"
        # a whole task against the plain version (raises if not equal)
        saved = [b.clone() for b in mine]
        words, n = K.blur_mega(fresh.to_words(), *mine, kind, cs.BG_ITERS,
                               budget, flag).result()
        want, _, want_n = make_megakernel(get_kernel(KERNELS[kind]))(
            fresh, plain, ints, None, budget, flag).result()
        torch.cuda.synchronize()
        assert n == want_n and np.array_equal(words, want.to_words()), key
        err[key] = max(cs.check(kind, a, b) for a, b in zip(mine, plain))
        for a, b, c in zip(mine, plain, saved):
            a.copy_(c)
            b.copy_(c)
        cases[key] = (lambda kind=kind, budget=budget: K.blur_mega(
            fresh.to_words(), *mine, kind, cs.BG_ITERS, budget, flag))
    cases[f"{kind}/b1_run"] = (lambda kind=kind: K.blur_rows(
        mine[0], mine[1], 0, ROW_BLOCK, kind, cs.RUN_BLOCKS))
runs = []
for _ in range(n_runs):
    runs.append({k: cs._named_ms(fn, "blur_rows" if "b1" in k
                                 else "blur_mega", 1)
                 for k, fn in cases.items()})
del mine, plain
# the megakernel arm of [mega]'s main path: a warm-up, then MEGA_AB_RUNS
main = []
for i in range(cs.MEGA_AB_RUNS + 1):
    tasks, urgent, rep, wall_s, _ = cs.serve(imgs, 0.0, engine="megakernel")
    every = (*tasks, urgent)
    if i:
        main.append({"wall_ms": wall_s * 1e3,
                     "host_ms_per_task": sum(t.run_s for t in every)
                     / len(every) * 1e3,
                     "urgent_service_ms": urgent.service_time * 1e3,
                     "megakernel_launches": rep["megakernel_launches"]})
print("AB " + json.dumps({"build": build, "err": err, "runs": runs,
                          "main": main}))
"""


def ab_mega_main(other: str) -> int:
    """``--ab-mega OTHER_TREE``: M1's device time per launch and per chunk
    of a 3-iteration 4096^2 task at ``MEGA_TIME_BUDGETS``, median and
    gaussian, B1's main-path run, and the megakernel arm of ``[mega]``'s
    main path (wall, host time per task, urgent service), with another
    tree's kernels and path and with this tree's, one process each,
    other, this, this, other; every process builds its tree's ``blur``,
    holds each task against the plain version (median bitwise, gaussian
    within 1e-6) and logs the ptxas register and spill lines.  The inputs
    and timers are this script's."""
    import os
    import statistics

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.core.context import ContextRecord
    from repro_torch.kernels.blur.kernel import mega_plan

    trees = {"other": str(Path(other).resolve()), "this": str(ROOT)}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log(f"[ab-mega] {card_line()}; other = {trees['other']}, this = "
        f"{trees['this']}; {AB_RUNS} timings a case a process")
    got = {"other": [], "this": []}
    main = {"other": [], "this": []}
    for arm in ("other", "this", "this", "other"):
        out = subprocess.run(
            [sys.executable, "-c", _AB_MEGA_WORKER, trees[arm],
             str(AB_RUNS)], capture_output=True, text=True, env=env,
            cwd=str(ROOT), timeout=TIMEOUT_S)
        if out.returncode != 0:
            raise AssertionError(f"[ab-mega] {arm}: exit {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        res = json.loads(next(ln for ln in out.stdout.splitlines()
                              if ln.startswith("AB "))[3:])
        for line in res["build"]:
            log(f"[ab-mega] {arm} blur build: {line}")
        log(f"[ab-mega] {arm}: max abs difference from the plain version "
            f"{res['err']}")
        for r in res["runs"]:
            log(f"[ab-mega] {arm}: {json.dumps(r)}")
        for r in res["main"]:
            log(f"[ab-mega] {arm} main path, megakernel: {json.dumps(r)}")
        got[arm] += res["runs"]
        main[arm] += res["main"]
    fresh = ContextRecord.fresh().to_words()
    for name in got["this"][0]:
        chunks = 1
        if "budget_" in name:
            chunks = len(list(mega_plan(SIZE, SIZE, BG_ITERS,
                                        int(name.rsplit("_", 1)[1]),
                                        fresh).chunks()))
        for arm, rs in got.items():
            xs = [r[name] * 1e3 for r in rs if r[name] > 0]
            if xs:
                med = statistics.median(xs)
                log(f"[ab-mega] {name} profiler {arm}: median {med:.4f} us "
                    f"a launch ({med / chunks:.4f} us a chunk of {chunks}), "
                    f"range {min(xs):.4f}-{max(xs):.4f} over {len(xs)}")
    for arm, rs in main.items():
        for key in ("wall_ms", "host_ms_per_task", "urgent_service_ms"):
            xs = [r[key] for r in rs]
            log(f"[ab-mega] main path megakernel {arm} {key}: median "
                f"{statistics.median(xs):.4f}, range {min(xs):.4f}-"
                f"{max(xs):.4f} over {len(xs)} runs")
    return 0


def dryrun_main() -> int:
    """``--dryrun``: the ``[dryrun]`` phase alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"[card] {card} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    t0 = time.perf_counter()
    dry = dryrun_phase(torch.device("cuda", 0), card)
    log(f"[dryrun] {json.dumps(dry['checks'])}")
    log(f"[dryrun] {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun"]:
        sys.exit(dryrun_main())
    if sys.argv[1:2] == ["--ab"]:
        sys.exit(ab_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-attention"]:
        sys.exit(ab_attention_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-seq"]:
        sys.exit(ab_seq_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-mega"]:
        sys.exit(ab_mega_main(sys.argv[2]))
    sys.exit(main())
