"""Iteration-level request scheduling (Orca-style).

Counterpart of ``paddle_tpu/serving/scheduler.py``: the waiting queue,
FCFS admission into freed slots, and the power-of-2 prefill buckets.
In the reference the buckets bound the number of compiled prefill
programs; here they keep the kernel and matmul shapes to O(log max_len)
sizes. Admission takes the paged engine's page claim, strict FCFS by
default; ``lookahead`` lets a bounded number of blocked requests be
passed over.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from .sampling import SamplingParams

__all__ = ["Request", "FIFOScheduler", "bucket_for", "prefill_buckets"]


def _pow2_floor_bucket(min_bucket: int) -> int:
    # normalize to a power of 2 so bucket_for and prefill_buckets
    # enumerate the SAME set for any min_bucket
    return 1 << (max(1, min_bucket) - 1).bit_length()


def bucket_for(prompt_len: int, min_bucket: int, max_len: int) -> int:
    """Smallest power-of-2 >= prompt_len, floored at min_bucket
    (rounded up to a power of 2) and capped at max_len."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    b = max(_pow2_floor_bucket(min_bucket),
            1 << (prompt_len - 1).bit_length())
    return min(b, max_len)


def prefill_buckets(min_bucket: int, max_len: int) -> List[int]:
    """All bucket lengths bucket_for can produce."""
    out = []
    b = _pow2_floor_bucket(min_bucket)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


@dataclasses.dataclass
class Request:
    """One in-flight generation request."""
    rid: int
    prompt: np.ndarray                  # [T] int64
    max_new_tokens: int
    sampling: SamplingParams
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    # PREFILLING state (chunked prefill): tokens 0..prefill_pos-1 of
    # the prompt are written to the claimed slot's KV but the request
    # is not decoding yet; None = not mid-prefill (the only state an
    # unchunked engine sees)
    prefill_pos: Optional[int] = None
    finished: bool = False
    finish_reason: Optional[str] = None
    # absolute deadline on the ENGINE clock (None = no deadline)
    deadline: Optional[float] = None
    error: Optional[BaseException] = None
    # the client-disconnect flag: set (possibly from another thread)
    # when the client goes away; the engine cancels the request at the
    # next safe point (the step-boundary sweep, or mid-prefill) with
    # finish_reason "disconnect"
    cancel_requested: bool = False
    # tracing context (observability.TraceContext) the request's spans
    # parent to
    trace: Optional[object] = None
    _rng: Optional[np.random.RandomState] = None
    # the route of its admission, which recover() takes again: through
    # the chunk FIFO or not, the shared-prefix length its paged
    # admission matched, and its place in the engine's admission order
    _chunked: bool = False
    _shared_len: int = 0
    _admit_seq: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def output_ids(self) -> List[int]:
        return list(self.out_tokens)

    @property
    def full_ids(self) -> np.ndarray:
        """Prompt and generated tokens (what a draft proposer reads)."""
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens, np.int64)])

    # position the NEXT decode step writes at: the last generated
    # token's k/v goes in right after the prompt + earlier outputs
    @property
    def next_pos(self) -> int:
        return self.prompt_len + len(self.out_tokens) - 1


class FIFOScheduler:
    """First-come-first-served admission into freed slots, consulted
    every engine step: a request waits only for A slot."""

    def __init__(self):
        self._queue: Deque[Request] = deque()

    def add(self, req: Request) -> None:
        self._queue.append(req)

    def has_pending(self) -> bool:
        return bool(self._queue)

    @property
    def depth(self) -> int:
        return len(self._queue)

    def pending(self) -> List[Request]:
        """The waiting queue in FCFS order (what the no-leak audit
        reads)."""
        return list(self._queue)

    def admissions(self, free_slots: List[int], claim=None,
                   lookahead: int = 0,
                   unclaim=None) -> List[Tuple[int, Request]]:
        """Pair queued requests with free slots, FCFS, one per slot.

        ``claim`` (optional) gates each admission on a resource besides
        the slot: the paged engine passes its page reservation, so
        admission is bounded by FREE PAGES, not just free slots.
        ``claim(head)`` returning False stops the batch with the head
        still queued (no skipping ahead of a request that does not fit
        yet). A truthy claim is a committed reservation: the caller
        unwinds it if the admission later fails.

        ``lookahead`` bounds head-of-line blocking: when the head's
        claim fails, up to ``lookahead`` blocked requests may be passed
        over (keeping their queue positions) to admit a smaller request
        behind them that does fit. 0 (the default) is strict FCFS.

        A claim that RAISES mid-batch unwinds the claims already made
        (``unclaim``) and puts their requests back at the queue head in
        FCFS order before the exception propagates."""
        picked = []
        idx = 0          # scan position in the queue
        skipped = 0      # blocked requests passed over (<= lookahead)
        for slot in free_slots:
            got = None
            while idx < len(self._queue):
                req = self._queue[idx]
                try:
                    ok = claim is None or claim(req)
                except BaseException:
                    for _, r in reversed(picked):
                        if unclaim is not None:
                            unclaim(r)
                        self.requeue(r)
                    raise
                if ok:
                    got = req
                    del self._queue[idx]
                    break
                skipped += 1
                if skipped > lookahead:
                    break
                idx += 1
            if got is None:
                break
            picked.append((slot, got))
        return picked

    def requeue(self, req: Request) -> None:
        """Put a request back at the HEAD (a failed admission keeps its
        FCFS position)."""
        self._queue.appendleft(req)

    def remove(self, req: Request) -> bool:
        """Drop one queued request (cancellation); False if absent."""
        try:
            self._queue.remove(req)
            return True
        except ValueError:
            return False

    def expire(self, now: float) -> List[Request]:
        """Pop every queued request whose deadline has passed."""
        out = [r for r in self._queue
               if r.deadline is not None and now > r.deadline]
        for r in out:
            self._queue.remove(r)
        return out

    def drain(self) -> List[Request]:
        """Pop the whole queue (engine shutdown cutoff)."""
        out = list(self._queue)
        self._queue.clear()
        return out
