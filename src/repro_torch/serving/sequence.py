"""Sequences: the serving engine's unit of work (DESIGN.md §9).

A ``Sequence`` is one generation request — a prompt, sampling parameters,
and the lifecycle bookkeeping the continuous batcher needs.  Its KV state
never lives here: during a round it is device-resident in the decode
task's buffers (and, across preemptions, in the region's ``ContextBank``
exactly like any preempted kernel); between rounds the engine threads the
device array straight into the next round's ``ArgBundle``.

``SequenceHandle`` is the client-side future: an *iterator of decoded
tokens* that blocks until the next token streams out, plus the familiar
``wait``/``result`` future surface mirroring ``TaskHandle``.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Sequence as Seq, Tuple


class SequenceError(RuntimeError):
    """The sequence failed terminally (its prefill or a decode round)."""


class SequenceCancelled(RuntimeError):
    """The sequence was cancelled before it finished."""


@dataclass(frozen=True)
class SamplingParams:
    """Greedy decoding over the deterministic surrogate LM.  ``seed``
    perturbs the initial hidden state, so two sequences with the same
    prompt but different seeds stream different tokens."""
    max_new_tokens: int = 16
    seed: int = 0
    temperature: float = 0.0  # only greedy (0.0) is implemented

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.temperature != 0.0:
            raise ValueError("only greedy decoding (temperature=0.0) is "
                             "implemented")


class SequenceStatus(Enum):
    WAITING = "waiting"        # submitted, prefill not yet dispatched
    PREFILLING = "prefilling"  # prefill task in flight
    READY = "ready"            # prefilled, waiting for a decode slot
    DECODING = "decoding"      # occupying a decode slot
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"


_sids = itertools.count()


@dataclass
class Sequence:
    """One generation request plus its lifecycle bookkeeping."""
    prompt: Tuple[int, ...]
    params: SamplingParams = field(default_factory=SamplingParams)
    tenant: str = "default"
    sid: int = field(default_factory=lambda: next(_sids))
    status: SequenceStatus = SequenceStatus.WAITING
    tokens: List[int] = field(default_factory=list)  # generated so far
    slot: Optional[int] = None          # decode slot while DECODING
    # metrics
    t_submit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    n_preemptions: int = 0   # decode-round preemptions while resident
    n_migrations: int = 0    # decode-round migrations while resident

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError("prompt must be non-empty")

    @property
    def time_to_first_token(self) -> Optional[float]:
        if self.t_submit is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    def __repr__(self):
        return (f"Sequence(#{self.sid} len={len(self.prompt)} "
                f"max_new={self.params.max_new_tokens} "
                f"{self.status.value})")


class SequenceHandle:
    """Client future for one streamed sequence.

    Iterating yields decoded token ids as they stream out of decode
    rounds (blocking between rounds); ``result()`` blocks for the full
    token list.  Engine-side, ``_push``/``_finish``/``_fail`` feed it.
    """

    def __init__(self, sequence: Sequence):
        self.sequence = sequence
        self._cv = threading.Condition()
        self._tokens: List[int] = []
        self._done = False
        self._exception: Optional[BaseException] = None
        self._cursor = 0  # iterator position (single-consumer)

    # -- client side -----------------------------------------------------
    @property
    def sid(self) -> int:
        return self.sequence.sid

    @property
    def status(self) -> SequenceStatus:
        return self.sequence.status

    def done(self) -> bool:
        with self._cv:
            return self._done

    def tokens(self) -> List[int]:
        """Snapshot of the tokens streamed so far (non-blocking)."""
        with self._cv:
            return list(self._tokens)

    def wait(self, timeout: Optional[float] = None) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: self._done, timeout)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the sequence settles; the full generated token
        list on success."""
        with self._cv:
            if not self._cv.wait_for(lambda: self._done, timeout):
                raise TimeoutError(
                    f"sequence #{self.sid} not done within {timeout}s "
                    f"(status={self.status.value})")
            if self._exception is not None:
                raise SequenceError(
                    f"sequence #{self.sid} failed") from self._exception
            if self.sequence.status is SequenceStatus.CANCELLED:
                raise SequenceCancelled(
                    f"sequence #{self.sid} was cancelled")
            return list(self._tokens)

    def __iter__(self) -> "SequenceHandle":
        return self

    def __next__(self) -> int:
        with self._cv:
            self._cv.wait_for(
                lambda: self._cursor < len(self._tokens) or self._done)
            if self._cursor < len(self._tokens):
                tok = self._tokens[self._cursor]
                self._cursor += 1
                return tok
            if self._exception is not None:
                raise SequenceError(
                    f"sequence #{self.sid} failed") from self._exception
            raise StopIteration

    # -- engine side -----------------------------------------------------
    def _push(self, tokens: Seq[int]):
        with self._cv:
            self._tokens.extend(int(t) for t in tokens)
            self._cv.notify_all()

    def _finish(self):
        with self._cv:
            self._done = True
            self._cv.notify_all()

    def _fail(self, exc: BaseException):
        with self._cv:
            if not self._done:
                self._exception = exc
                self._done = True
                self._cv.notify_all()
