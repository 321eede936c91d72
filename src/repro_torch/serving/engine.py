"""Continuous-batching token-serving engine (DESIGN.md §9) — the port of
``repro/serving/engine.py``, behaviour unchanged but for the device: the LM
backends live on the backend shell's device, and the engine drops a
finished task's device buffers once the LM has harvested them (the
reference keeps them).  The engine adopts the backend's flight recorder
and metrics registry (``repro_torch.obs``), so its ``seq_submit``,
``prefill_dispatch``, ``ttft``, ``decode_round`` and ``slot_busy`` events
share the timeline of the regions that ran them, and its report's
``trace``/``telemetry`` sections read them (``{"enabled": False}``
without).

The engine turns a stream of ``Sequence`` submissions into region tasks:

- one **prefill** task per sequence (``SeqPrefill`` bitstream) folds the
  prompt and emits the first token;
- a rolling series of **decode rounds** (``SeqDecode`` bitstream), each a
  single region task advancing every resident slot by up to
  ``round_tokens`` tokens.  Round boundaries are chunk boundaries: newly
  prefilled sequences are admitted into free slots there, finished ones
  evicted — the classic continuous-batching loop, expressed in the
  paper's task vocabulary.

Phase disaggregation is plain scheduler policy: prefill and decode tasks
get distinct priorities (so neither phase head-blocks the other in the
FCFS queues) and optional ``region_pin`` sets.  Pinning decode to its
own region keeps the ``SeqDecode`` bitstream permanently loaded there —
every round coalesces onto the warm region while prefills thrash the
other regions' bitstreams, which is exactly the win ``bench_decode``
measures.

KV state lives device-side: prefill/decode kernels are registered with
``device_result=True``, so a round's state buffers come back as device
tensors, each marked with its producer's event, and are threaded straight
into the next round's ``ArgBundle`` (``state_device_rounds`` counts the
rounds that never touched the host).
Mid-round preemption/migration rides the existing context machinery —
the engine never sees it except in the task's counters.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from repro_torch.core.reporting import safe_rate, stamp
from repro_torch.core.streams import record_ready, to_host, wait_ready
from repro_torch.core.task import Task
from repro_torch.obs.metrics import trace_section
from repro_torch.obs.slo import telemetry_section
from repro_torch.serving.kernels import (COL_ACTIVE, COL_LAST_TOK, COL_N_EMIT,
                                         init_state)
from repro_torch.serving.sequence import (SamplingParams, Sequence,
                                          SequenceError, SequenceHandle,
                                          SequenceStatus)

PREFILL_OUT_W = 8   # SeqPrefill out buffer width (token lands in [0, 0])
SLOTS_W = 8         # SeqDecode slots-table width (3 columns used)


@dataclass
class ServingConfig:
    """Engine knobs.  ``lm`` selects the model backend: ``"surrogate"``
    (the deterministic integer LM) or ``"attention"`` (the paged-KV real
    attention path, DESIGN.md §13).  ``d_model``/``vocab_size``
    parameterize either LM; ``max_slots``/``round_tokens`` size the
    decode round (S sequences x R tokens); ``prompt_pad`` buckets
    surrogate prompt lengths so every prefill of a bucket shares one
    bitstream (the attention LM always pads to ``max_ctx`` instead, so
    one prefill bitstream serves every batch bit-identically)."""
    lm: str = "surrogate"
    d_model: int = 64
    vocab_size: int = 101
    max_slots: int = 4
    round_tokens: int = 4
    prompt_pad: int = 16
    prefill_priority: int = 1
    decode_priority: int = 2
    # hard region pins (shell-local rids); None = schedule anywhere.
    prefill_regions: Optional[Seq[int]] = None
    decode_regions: Optional[Seq[int]] = None
    max_prefills_inflight: int = 4
    # blocking timeouts for one prefill / one decode round (safety net —
    # a wedged region must fail sequences loudly, not hang the driver)
    prefill_timeout_s: float = 120.0
    round_timeout_s: float = 120.0
    # test/CI hook: force a checkpoint-preempt probe on every Nth decode
    # round (0 = never).  The probe waits for the round task to start,
    # then requests a preempt on its region — the round checkpoint-resumes
    # and must stream bit-identical tokens.
    preempt_probe_every: int = 0
    # attention-LM knobs (ignored by the surrogate): model geometry,
    # KV page size, context capacity, and the pool size (None = enough
    # pages for every slot to hold max_ctx, so admission never blocks)
    attn_heads: int = 4
    attn_kv_heads: int = 2
    attn_head_dim: int = 16
    kv_block_size: int = 8
    max_ctx: int = 64
    kv_blocks: Optional[int] = None
    weights_seed: int = 7
    # sequences packed into one prefill task (attention LM; the
    # surrogate keeps its one-task-per-sequence prefill path)
    prefill_batch: int = 1

    def validate(self) -> "ServingConfig":
        for name in ("d_model", "vocab_size", "max_slots", "round_tokens",
                     "prompt_pad", "max_prefills_inflight", "prefill_batch"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.lm not in ("surrogate", "attention"):
            raise ValueError(f"unknown lm {self.lm!r}; "
                             f"known: ('surrogate', 'attention')")
        return self


class SurrogateLM:
    """The integer-surrogate LM behind the engine's backend interface.

    The engine is LM-agnostic: a backend builds prefill/decode
    ArgBundles, harvests their result buffers, and owns whatever
    per-sequence state the model threads between tasks.  This one keeps
    the PR-5 behaviour exactly: one prefill task per sequence, a
    device-resident ``[S, D]`` hidden-state block threaded
    round-to-round, no KV pages."""

    name = "surrogate"
    prefill_batch = 1

    def __init__(self, cfg, device, metrics=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self._state: Dict[int, object] = {}   # sid -> device state [1, D]
        self._round_state = None              # device [S, D] or None

    # -- admission -------------------------------------------------------
    def reject(self, seq) -> Optional[str]:
        return None

    def can_admit(self, seq) -> bool:
        return True

    # -- prefill ---------------------------------------------------------
    def prefill_bundle(self, seqs):
        from repro_torch.controller.kernels import get_kernel

        cfg = self.cfg
        (seq,) = seqs
        P = -(-len(seq.prompt) // cfg.prompt_pad) * cfg.prompt_pad
        prompt = np.zeros((1, P), np.int32)
        prompt[0, :len(seq.prompt)] = seq.prompt
        out = np.zeros((1, PREFILL_OUT_W), np.int32)
        state = init_state(seq.params.seed, cfg.d_model)[None, :]
        kd = get_kernel("SeqPrefill")
        return "SeqPrefill", kd.bundle(
            out, state, prompt, P=P, D=cfg.d_model, vocab=cfg.vocab_size,
            prompt_len=len(seq.prompt))

    def harvest_prefill(self, seqs, bufs) -> List[int]:
        (seq,) = seqs
        # device-resident [1, D], spliced into a round on this thread
        self._state[seq.sid] = wait_ready(bufs[1])
        return [int(to_host(bufs[0])[0, 0])]

    # -- decode ----------------------------------------------------------
    def decode_bundle(self, occupied, inserted, n_emit):
        from repro_torch.controller.kernels import get_kernel

        cfg = self.cfg
        S, R, D = cfg.max_slots, cfg.round_tokens, cfg.d_model
        slots_tbl = np.zeros((S, SLOTS_W), np.int32)
        for i, seq in occupied:
            slots_tbl[i, COL_ACTIVE] = 1
            slots_tbl[i, COL_N_EMIT] = n_emit[i]
            slots_tbl[i, COL_LAST_TOK] = seq.tokens[-1]

        # state composition: start from last round's device-resident state
        # when we have one (rows of evicted slots are stale but inactive),
        # else a fresh zero block; splice prefilled state into new slots.
        # (the port splices in place, after the last round's event)
        if self._round_state is not None:
            state = self._round_state
            device_resident = not inserted
        else:
            state = torch.zeros((S, D), dtype=torch.int32,
                                device=self.device)
            device_resident = False
        if inserted:
            wait_ready(state)
            by_slot = dict(occupied)
            for i in inserted:
                state[i, :] = self._state.pop(by_slot[i].sid)[0]
            record_ready([state], self.device)
        out = np.zeros((S, R), np.int32)
        kd = get_kernel("SeqDecode")
        return "SeqDecode", kd.bundle(out, state, slots_tbl, S=S, D=D, R=R,
                                      vocab=cfg.vocab_size), device_resident

    def finish_round(self, bufs) -> np.ndarray:
        self._round_state = bufs[1]   # device-resident into the next round
        return to_host(bufs[0])

    def fail_round(self):
        self._round_state = None

    def drop(self, sid: int):
        self._state.pop(sid, None)

    # -- observability ---------------------------------------------------
    def kv_stats(self) -> Optional[dict]:
        return None

    def trace_attrs(self) -> dict:
        return {}


def make_lm(cfg, device, metrics=None):
    """Backend factory for ``ServingConfig.lm``, on ``device``."""
    if cfg.lm == "surrogate":
        return SurrogateLM(cfg, device, metrics=metrics)
    if cfg.lm == "attention":
        from repro_torch.serving.attention import AttentionLM

        return AttentionLM(cfg, device, metrics=metrics)
    raise ValueError(f"unknown lm {cfg.lm!r}")


@dataclass
class _Stats:
    t_first_submit: Optional[float] = None
    t_last_done: Optional[float] = None
    n_finished: int = 0
    n_failed: int = 0
    n_cancelled: int = 0
    stranded: int = 0
    tokens_out: int = 0
    prefill_tasks: int = 0
    decode_rounds: int = 0
    slot_inserts: int = 0
    slot_evictions: int = 0
    max_slots_used: int = 0
    decode_preemptions: int = 0
    decode_migrations: int = 0
    state_device_rounds: int = 0
    ttfts: List[float] = field(default_factory=list)


class ServingEngine:
    """Drives a scheduler-like backend (the port's ``Scheduler`` or
    ``ClusterFrontend``: anything with ``submit(task) -> handle`` and a
    ``shell``, or ``nodes`` of shells, whose first device holds the LM's
    weights and state).  The backend's serving loop must
    already be running; the engine only adds its own driver thread on
    ``start()``."""

    def __init__(self, backend, config: Optional[ServingConfig] = None):
        if not hasattr(backend, "submit"):
            raise TypeError(
                f"backend must expose submit(task); got "
                f"{type(backend).__name__}")
        self.backend = backend
        # flight recorder and live metrics registry: the backend's handles
        # (the port's Scheduler exposes both), so serving events and
        # histograms share the timeline and registry of the regions that
        # ran them; None disables each at zero cost
        self.tracer = getattr(backend, "tracer", None)
        self.metrics = getattr(backend, "metrics", None)
        self._trace_track = ("serving", 0)
        self.cfg = (config or ServingConfig()).validate()
        # the LM backend: builds prefill/decode bundles, owns the model
        # state threaded between tasks (hidden-state block or KV pools)
        # a cluster frontend's LM lives on its first node's shell's device
        shell = (backend.shell if hasattr(backend, "shell")
                 else backend.nodes[0].shell)
        self.lm = make_lm(self.cfg, shell.devices[0], metrics=self.metrics)
        self._slot_t0: List[Optional[float]] = [None] * self.cfg.max_slots
        self.stats = _Stats()
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._waiting: deque = deque()            # (seq, handle)
        self._prefills: List[tuple] = []          # (seqs, handles, th)
        self._ready: deque = deque()              # (seq, handle)
        self._slots: List[Optional[tuple]] = [None] * self.cfg.max_slots
        self._handles: Dict[int, SequenceHandle] = {}
        self._stop = threading.Event()
        self._drain = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._settled = threading.Event()
        self._rounds_since_probe = 0

    # -- client side -----------------------------------------------------
    def submit(self, prompt, params: Optional[SamplingParams] = None,
               tenant: str = "default") -> SequenceHandle:
        seq = Sequence(prompt=tuple(prompt),
                       params=params or SamplingParams(), tenant=tenant)
        return self.submit_sequence(seq)

    def submit_sequence(self, seq: Sequence) -> SequenceHandle:
        handle = SequenceHandle(seq)
        with self._lock:
            if self._closed:
                raise RuntimeError("serving engine is closed (draining)")
            seq.t_submit = time.perf_counter()
            if self.stats.t_first_submit is None:
                self.stats.t_first_submit = seq.t_submit
            self._waiting.append((seq, handle))
            self._handles[seq.sid] = handle
            self._settled.clear()
        if self.tracer is not None:
            self.tracer.emit("seq_submit", self._trace_track, tid=seq.sid,
                             prompt_len=len(seq.prompt))
        if self.metrics is not None:
            self.metrics.counter("serving_seqs_total",
                                 tenant=seq.tenant).inc()
        self._work.set()
        return handle

    def cancel(self, sid: int) -> bool:
        """Cancel a sequence not yet resident in a decode slot.  Returns
        False once it is decoding (or already settled)."""
        with self._lock:
            for q in (self._waiting, self._ready):
                for item in list(q):
                    if item[0].sid == sid:
                        q.remove(item)
                        self._settle(item[0], SequenceStatus.CANCELLED)
                        return True
            for i, (seqs, handles, th) in enumerate(list(self._prefills)):
                # a batched prefill is cancellable only when the whole
                # task is this one sequence — batch-mates must not be
                # collateral damage
                if (len(seqs) == 1 and seqs[0].sid == sid and th.cancel()):
                    self._prefills.pop(i)
                    self._settle(seqs[0], SequenceStatus.CANCELLED)
                    return True
        return False

    def start(self) -> "ServingEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._thread = threading.Thread(target=self._drive,
                                        name="serving-engine", daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Refuse new sequences, finish everything submitted, stop the
        driver, return the final report."""
        with self._lock:
            self._closed = True
        self._drain.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"serving engine did not drain within {timeout}s")
            self._thread = None
        return self.report()

    def shutdown(self, timeout: Optional[float] = None) -> dict:
        """Stop serving: cancel everything not yet decoding, finish the
        current round, stop the driver."""
        with self._lock:
            self._closed = True
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        return self.report()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted sequence has settled (the engine
        keeps serving; use ``drain`` to also stop it)."""
        return self._settled.wait(timeout)

    # -- driver ----------------------------------------------------------
    def _drive(self):
        try:
            while True:
                if self._stop.is_set():
                    self._cancel_pending()
                self._dispatch_prefills()
                self._harvest_prefills()
                did_round = False
                if any(self._slots) or self._ready:
                    self._decode_round()
                    did_round = True
                with self._lock:
                    live = (self._waiting or self._prefills or self._ready
                            or any(self._slots))
                    if not live:
                        self._settled.set()
                        if self._drain.is_set() or self._stop.is_set():
                            break
                if not did_round:
                    self._work.wait(0.02)
                    self._work.clear()
        except BaseException as exc:  # noqa: BLE001 — driver must not die
            self._fail_everything(exc)  # silently with sequences stranded
            raise
        finally:
            self._strand_leftovers()

    def _cancel_pending(self):
        with self._lock:
            while self._waiting:
                seq, _ = self._waiting.popleft()
                self._settle(seq, SequenceStatus.CANCELLED)
            while self._ready:
                seq, _ = self._ready.popleft()
                self._settle(seq, SequenceStatus.CANCELLED)
            for seqs, handles, th in list(self._prefills):
                if th.cancel():
                    self._prefills.remove((seqs, handles, th))
                    for seq in seqs:
                        self._settle(seq, SequenceStatus.CANCELLED)

    # -- prefill path ----------------------------------------------------
    def _dispatch_prefills(self):
        cfg = self.cfg
        while True:
            with self._lock:
                if (not self._waiting
                        or len(self._prefills) >= cfg.max_prefills_inflight):
                    return
                batch = []
                while self._waiting and len(batch) < self.lm.prefill_batch:
                    batch.append(self._waiting.popleft())
            seqs, handles = [], []
            for seq, handle in batch:
                err = self.lm.reject(seq)
                if err is not None:
                    with self._lock:
                        self._settle(seq, SequenceStatus.FAILED,
                                     SequenceError(err))
                    continue
                seqs.append(seq)
                handles.append(handle)
            if not seqs:
                continue
            kernel, bundle = self.lm.prefill_bundle(seqs)
            task = Task(
                kernel=kernel, args=bundle,
                priority=cfg.prefill_priority,
                tenant=seqs[0].tenant, phase="prefill",
                sequence=(seqs[0].sid if len(seqs) == 1
                          else tuple(s.sid for s in seqs)),
                region_pin=(frozenset(cfg.prefill_regions)
                            if cfg.prefill_regions is not None else None),
            )
            th = self.backend.submit(task)
            for seq in seqs:
                if self.tracer is not None:
                    self.tracer.emit("prefill_dispatch", self._trace_track,
                                     tid=seq.sid)
                seq.status = SequenceStatus.PREFILLING
            with self._lock:
                self._prefills.append((seqs, handles, th))
                self.stats.prefill_tasks += 1

    def _harvest_prefills(self):
        with self._lock:
            batch = list(self._prefills)
        for seqs, handles, th in batch:
            if not th.done():
                continue
            with self._lock:
                self._prefills.remove((seqs, handles, th))
            try:
                bufs = th.result(0)
            except Exception as exc:  # noqa: BLE001 — fail just this batch
                with self._lock:
                    for seq in seqs:
                        self._settle(seq, SequenceStatus.FAILED, exc)
                continue
            firsts = self.lm.harvest_prefill(seqs, bufs)
            self._release(th)
            for seq, handle, first in zip(seqs, handles, firsts):
                with self._lock:
                    seq.t_first_token = time.perf_counter()
                    self.stats.ttfts.append(seq.time_to_first_token)
                    seq.tokens.append(first)
                    self.stats.tokens_out += 1
                if self.tracer is not None:
                    self.tracer.emit("ttft", self._trace_track, tid=seq.sid,
                                     ttft_s=seq.time_to_first_token)
                if self.metrics is not None:
                    self.metrics.histogram(
                        "serving_ttft_seconds", tenant=seq.tenant,
                    ).observe(seq.time_to_first_token)
                    self.metrics.counter("serving_tokens_total",
                                         tenant=seq.tenant).inc()
                handle._push([first])
                if len(seq.tokens) >= seq.params.max_new_tokens:
                    with self._lock:
                        self._settle(seq, SequenceStatus.FINISHED)
                else:
                    seq.status = SequenceStatus.READY
                    with self._lock:
                        self._ready.append((seq, handle))

    # -- decode rounds ---------------------------------------------------
    def _decode_round(self):
        cfg = self.cfg
        tr = self.tracer
        S, R = cfg.max_slots, cfg.round_tokens
        inserted = []
        with self._lock:
            for i in range(S):
                if self._slots[i] is None and self._ready:
                    # LM-side admission gate (the attention LM defers a
                    # sequence the KV pool cannot page in yet; FIFO — no
                    # head-of-line skipping, deferral is loud in kv stats)
                    if not self.lm.can_admit(self._ready[0][0]):
                        break
                    seq, handle = self._ready.popleft()
                    seq.status = SequenceStatus.DECODING
                    seq.slot = i
                    self._slots[i] = (seq, handle)
                    inserted.append(i)
                    self.stats.slot_inserts += 1
                    self._slot_t0[i] = time.perf_counter()
                    if tr is not None:
                        tr.emit("slot_insert", ("slot", i), tid=seq.sid)
            occupied = [(i, s) for i, s in enumerate(self._slots)
                        if s is not None]
            self.stats.max_slots_used = max(self.stats.max_slots_used,
                                            len(occupied))
        if not occupied:
            return

        n_emit = {i: min(R, seq.params.max_new_tokens - len(seq.tokens))
                  for i, (seq, _h) in occupied}
        kernel, bundle, device_resident = self.lm.decode_bundle(
            [(i, seq) for i, (seq, _h) in occupied], inserted, n_emit)
        task = Task(
            kernel=kernel, args=bundle,
            priority=cfg.decode_priority, phase="decode",
            sequence=tuple(seq.sid for _, (seq, _h) in occupied),
            region_pin=(frozenset(cfg.decode_regions)
                        if cfg.decode_regions is not None else None),
        )
        t_round0 = time.perf_counter()
        probe = self._maybe_probe_preempt(task)
        th = self.backend.submit(task)
        if probe is not None:
            probe()
        try:
            bufs = th.result(cfg.round_timeout_s)
        except Exception as exc:  # noqa: BLE001 — the round is the blast
            # radius: every resident sequence fails, slots clear
            with self._lock:
                for i, (seq, _h) in occupied:
                    self._slots[i] = None
                    self._evict_trace(i, seq.sid)
                    self._settle(seq, SequenceStatus.FAILED, exc)
                self.lm.fail_round()
                self.stats.decode_rounds += 1
            if tr is not None:
                tr.emit_span("decode_round", self._trace_track, t_round0,
                             n_slots=len(occupied), failed=True)
            return
        out_np = self.lm.finish_round(bufs)
        self._release(th)
        if tr is not None:
            tr.emit_span("decode_round", self._trace_track, t_round0,
                         n_slots=len(occupied), inserted=len(inserted),
                         **self.lm.trace_attrs())

        # cluster migration resumes a *clone*; the handle tracks the final
        # incarnation whose counters include every hop
        final = getattr(th, "task", None) or task
        with self._lock:
            self.stats.decode_rounds += 1
            if device_resident:
                self.stats.state_device_rounds += 1
            self.stats.decode_preemptions += final.n_preemptions
            self.stats.decode_migrations += final.n_migrations
        if self.metrics is not None:
            self.metrics.counter("serving_decode_rounds_total").inc()
        for i, (seq, handle) in occupied:
            n = n_emit[i]
            toks = [int(t) for t in out_np[i, :n]]
            seq.tokens.extend(toks)
            with self._lock:
                self.stats.tokens_out += n
            if self.metrics is not None and n:
                self.metrics.counter("serving_tokens_total",
                                     tenant=seq.tenant).inc(n)
            handle._push(toks)
            if len(seq.tokens) >= seq.params.max_new_tokens:
                with self._lock:
                    self._slots[i] = None
                    self.stats.slot_evictions += 1
                    self._evict_trace(i, seq.sid)
                    self._settle(seq, SequenceStatus.FINISHED)

    @staticmethod
    def _release(th):
        """The LM has taken what it needs from a finished task's device
        buffers (tokens to the host, K/V and state into its own
        references): drop the task's result, so its private copies — each
        holds the attention LM's weights, 2.66 GB at Qwen3-8B's widths —
        do not live on in the scheduler's list of finished tasks."""
        task = getattr(th, "task", None)
        if task is not None:
            task.result = None

    def _evict_trace(self, slot: int, sid: int):
        """Close the slot's occupancy span in the trace (if tracing)."""
        t0 = self._slot_t0[slot]
        self._slot_t0[slot] = None
        if self.tracer is not None and t0 is not None:
            self.tracer.emit_span("slot_busy", ("slot", slot), t0, tid=sid)

    def _maybe_probe_preempt(self, task: Task):
        """CI/test hook: checkpoint-preempt every Nth round once,
        mid-flight; called before the round is submitted.  In megakernel
        mode it arms the round's one-shot flag boundary there, so the
        launch exits at its first chunk boundary whatever the threads'
        timing (the reference arms it after the submission, which a quick
        dispatch can outrun).  Otherwise it returns the probe to start once
        the round is submitted: a thread that races the round to its
        region; where a preemption must land for certain, tests place it
        with the region's ``on_chunk`` hook."""
        every = self.cfg.preempt_probe_every
        if not every:
            return None
        self._rounds_since_probe += 1
        if self._rounds_since_probe < every:
            return None
        shell = getattr(self.backend, "shell", None)
        if shell is None:
            return None
        self._rounds_since_probe = 0
        if getattr(shell, "engine_mode", None) == "megakernel":
            # a megakernel round is one launch with no host chunk boundary
            # to race: arm the one-shot flag instead
            task.preempt_at_boundary = 1
            return None

        def probe():
            deadline = time.perf_counter() + 5.0
            while time.perf_counter() < deadline:
                rid = task.last_dispatched_rid
                if rid is not None and task.n_preemptions == 0:
                    region = shell.region(rid)
                    if region.current_task is task:
                        region.request_preempt()
                        return
                time.sleep(0.002)

        return threading.Thread(target=probe, daemon=True).start

    # -- settling --------------------------------------------------------
    def _settle(self, seq: Sequence, status: SequenceStatus,
                exc: Optional[BaseException] = None):
        """Caller holds the lock."""
        seq.status = status
        seq.slot = None
        seq.t_done = time.perf_counter()
        self.stats.t_last_done = seq.t_done
        handle = self._handles.get(seq.sid)
        if status is SequenceStatus.FINISHED:
            self.stats.n_finished += 1
        elif status is SequenceStatus.CANCELLED:
            self.stats.n_cancelled += 1
        elif status is SequenceStatus.FAILED:
            self.stats.n_failed += 1
        self.lm.drop(seq.sid)
        if handle is not None:
            if exc is not None:
                handle._fail(exc)
            else:
                handle._finish()

    def _fail_everything(self, exc: BaseException):
        with self._lock:
            for q in (self._waiting, self._ready):
                while q:
                    seq, _ = q.popleft()
                    self._settle(seq, SequenceStatus.FAILED, exc)
            for seqs, _h, _th in self._prefills:
                for seq in seqs:
                    self._settle(seq, SequenceStatus.FAILED, exc)
            self._prefills.clear()
            for i, s in enumerate(self._slots):
                if s is not None:
                    self._slots[i] = None
                    self._evict_trace(i, s[0].sid)
                    self._settle(s[0], SequenceStatus.FAILED, exc)

    def _strand_leftovers(self):
        """Driver exit: any sequence still unsettled is stranded — settle
        its handle loudly so no client blocks forever."""
        with self._lock:
            for sid, handle in self._handles.items():
                if not handle.done():
                    self.stats.stranded += 1
                    handle._fail(SequenceError(
                        f"sequence #{sid} stranded at engine exit "
                        f"(status={handle.status.value})"))
            self._settled.set()

    # -- observability ---------------------------------------------------
    def report(self) -> dict:
        st = self.stats
        with self._lock:
            ttfts = sorted(st.ttfts)
            t0 = st.t_first_submit
            t1 = st.t_last_done
            raw_wall = (t1 - t0) if (t0 and t1) else 0.0
            wall = max(raw_wall, 1e-9) if (t0 and t1) else 0.0

            def pct(vals, q):
                if not vals:
                    return 0.0
                return vals[min(len(vals) - 1,
                                int(round(q * (len(vals) - 1))))]

            return stamp("serving", {
                "n_sequences": len(self._handles),
                "n_finished": st.n_finished,
                "n_failed": st.n_failed,
                "n_cancelled": st.n_cancelled,
                "stranded_sequences": st.stranded,
                "tokens_out": st.tokens_out,
                # rate over the RAW wall: an instant serving window (t0 ==
                # t1 at clock resolution) reports 0.0, never a 1e9 rate
                "tokens_per_s": safe_rate(st.tokens_out, raw_wall),
                "wall_s": wall,
                "ttft_p50_s": pct(ttfts, 0.50),
                "ttft_p99_s": pct(ttfts, 0.99),
                "prefill_tasks": st.prefill_tasks,
                "decode_rounds": st.decode_rounds,
                "slot_inserts": st.slot_inserts,
                "slot_evictions": st.slot_evictions,
                "max_slots_used": st.max_slots_used,
                "decode_preemptions": st.decode_preemptions,
                "decode_migrations": st.decode_migrations,
                "state_device_rounds": st.state_device_rounds,
                "engine_mode": getattr(getattr(self.backend, "shell", None),
                                       "engine_mode", None),
                "lm": self.lm.name,
                "kv": self.lm.kv_stats(),
                "trace": trace_section(self.tracer),
                "telemetry": telemetry_section(self.metrics),
            })
