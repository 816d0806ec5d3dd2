"""Draft proposers for speculative decoding: n-gram (prompt-lookup)
drafts and a small draft model.

Counterpart of ``paddle_tpu/serving/spec_decode.py``. ``NgramProposer``
(:39-135) is a verbatim port: pure host code over each request's token
history (prompt + generated tokens), indexed by n-gram; when the
current suffix n-gram occurred before, the tokens that followed that
earlier occurrence are the draft. Proposals are a function of the
history alone (no RNG, no clock), so a replayed trace drafts the same
tokens, and the state is incremental per request (each call indexes
only the tokens appended since the last).

``DraftModelProposer`` (:137-383) drafts with a causal LM of its own
over a contiguous ``[max_slots, max_len, KV, D]`` pool per layer, slot-
mirrored to the engine's requests: each proposal first catches the
draft cache up to the confirmed history, then chains one-token
forwards for the draft tokens. Writes past the confirmed history are
overwritten by the next catch-up, so a rejected draft needs no
rollback here.

The engine releases a request's state when its slot is evicted
(finish, deadline, cancel) and keeps none after ``drain()``;
``resilience.engine_leak_violations`` audits that.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .sampling import sampling_dist

__all__ = ["NgramProposer", "DraftModelProposer"]

_EMPTY = np.zeros((0,), np.int64)


class NgramProposer:
    """Prompt-lookup draft proposer over per-request token history.

    ``ngram`` is the longest suffix n-gram matched (the proposer backs
    off to shorter n-grams down to ``min_ngram``: a single repeated
    token already drafts on a 1-gram); ``max_draft`` caps the proposed
    window (the engine passes ``spec_k - 1``). Matching prefers the
    longest n-gram, and within one length the most recent earlier
    occurrence.
    """

    def __init__(self, ngram: int = 2, max_draft: int = 3,
                 min_ngram: int = 1):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        if not 1 <= min_ngram <= ngram:
            raise ValueError(
                f"min_ngram must be in [1, ngram={ngram}], got "
                f"{min_ngram}")
        if max_draft < 0:
            raise ValueError(
                f"max_draft must be >= 0, got {max_draft}")
        self.ngram = int(ngram)
        self.min_ngram = int(min_ngram)
        self.max_draft = int(max_draft)
        # rid -> {"done": processed history length,
        #         "maps": {n: {ngram tuple: last end position}}}
        self._state: Dict[int, dict] = {}

    # -- state lifecycle (engine hooks) --------------------------------
    def release(self, rid: int) -> None:
        """Drop one request's index (slot eviction)."""
        self._state.pop(rid, None)

    def retain(self, rids: Iterable[int]) -> None:
        """Keep only the given requests' indexes (``drain()`` passes
        ())."""
        keep = set(rids)
        for rid in [r for r in self._state if r not in keep]:
            del self._state[rid]

    def tracked(self) -> list:
        """Rids with live index state (the no-leak audit surface)."""
        return sorted(self._state)

    def unwind(self, rid: int) -> None:
        """Discard one request's state after a failed draft; the next
        proposal indexes the confirmed history again."""
        self._state.pop(rid, None)

    # -- proposal ------------------------------------------------------
    def _update(self, st: dict, ids: np.ndarray) -> None:
        """Index every n-gram ending strictly before the final position
        (the suffix about to be looked up must only match earlier
        occurrences), resuming from the last processed length."""
        end = len(ids) - 1
        maps = st["maps"]
        for n in range(self.min_ngram, self.ngram + 1):
            m = maps[n]
            for i in range(max(n - 1, st["done"]), end):
                m[tuple(int(t) for t in ids[i - n + 1:i + 1])] = i
        st["done"] = end

    def propose(self, rid: int, ids: np.ndarray,
                max_tokens: Optional[int] = None) -> np.ndarray:
        """Draft up to ``max_tokens`` (default ``max_draft``) next tokens
        for the sequence ``ids`` (prompt + generated so far): an int64
        array, empty when nothing matches (the row then runs at k=1)."""
        want = self.max_draft if max_tokens is None \
            else min(int(max_tokens), self.max_draft)
        L = int(len(ids))
        if want < 1 or L < self.min_ngram + 1:
            return _EMPTY
        st = self._state.get(rid)
        if st is None or st["done"] > L - 1:
            # unknown rid, or the history shrank: index from scratch
            st = {"done": 0,
                  "maps": {n: {} for n in
                           range(self.min_ngram, self.ngram + 1)}}
            self._state[rid] = st
        self._update(st, ids)
        for n in range(min(self.ngram, L - 1), self.min_ngram - 1, -1):
            key = tuple(int(t) for t in ids[L - n:])
            pos = st["maps"][n].get(key)
            if pos is not None:
                draft = ids[pos + 1:pos + 1 + want]
                if len(draft):
                    return np.asarray(draft, np.int64)
        return _EMPTY


class DraftModelProposer:
    """Small-draft-model proposer (see module docstring).

    ``_state[rid]["n"]`` counts the confirmed tokens whose k/v writes
    are final. Every proposal first feeds the draft cache up to the
    whole confirmed history, re-feeding from ``min(n, L - 1)`` so the
    logits it drafts from are fresh, ``window`` tokens a forward with
    write length ``w``; then it chains write-length-1 forwards for the
    draft tokens. Greedy proposals are a function of (weights,
    history).

    The reference runs its one compiled program over all ``max_slots``
    rows to draft for one slot. Rows of that program are independent
    (each attends only over its own cache row), so this port runs the
    slot's ``[1, window]`` row alone, over a view of its pool row, and
    takes the LM head at the one position it drafts from.
    """

    def __init__(self, model, max_slots: int, max_len: int,
                 max_draft: int = 3):
        from .engine import _ModelAdapter      # circular at import time
        if max_slots < 1:
            raise ValueError(
                f"max_slots must be >= 1, got {max_slots}")
        if max_draft < 0:
            raise ValueError(
                f"max_draft must be >= 0, got {max_draft}")
        self.adapter = _ModelAdapter(model)
        model.eval()
        if self.adapter.max_positions < max_len:
            raise ValueError(
                f"draft model supports {self.adapter.max_positions} "
                f"positions < engine max_len={max_len}; speculation "
                "must cover the full target horizon")
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.max_draft = int(max_draft)
        # wide enough to chain a full draft and to batch catch-up
        self.window = max(1, self.max_draft + 1)
        self._ks = self._vs = None             # lazy [S, T, KV, D] pools
        # rid -> {"slot": draft-pool slot, "n": confirmed tokens whose
        # k/v writes are final}
        self._state: Dict[int, dict] = {}
        self._free = list(range(self.max_slots - 1, -1, -1))

    # -- state lifecycle (engine hooks, as NgramProposer's) ------------
    def release(self, rid: int) -> None:
        st = self._state.pop(rid, None)
        if st is not None:
            self._free.append(st["slot"])

    def retain(self, rids: Iterable[int]) -> None:
        keep = set(rids)
        for rid in [r for r in self._state if r not in keep]:
            self.release(rid)

    def tracked(self) -> list:
        return sorted(self._state)

    def leased_slots(self) -> list:
        """Draft-pool slots held by tracked requests."""
        return sorted(st["slot"] for st in self._state.values())

    def unwind(self, rid: int) -> None:
        """Drop one request's draft state; the next proposal feeds the
        confirmed history from scratch."""
        self.release(rid)

    def reset(self) -> None:
        """Drop all draft state and the pools (allocated again on the
        next proposal): the engine's answer to a draft forward that
        failed part-way through its in-place writes."""
        self._state.clear()
        self._free = list(range(self.max_slots - 1, -1, -1))
        self._ks = self._vs = None

    def free_slots(self) -> int:
        return len(self._free)

    # -- the draft forward ---------------------------------------------
    def _pools(self):
        if self._ks is None:
            ad = self.adapter
            shape = (self.max_slots, self.max_len, ad.kv_heads,
                     ad.head_dim)
            self._ks = [torch.zeros(shape, dtype=ad.dtype, device=ad.device)
                        for _ in range(ad.num_layers)]
            self._vs = [torch.zeros(shape, dtype=ad.dtype, device=ad.device)
                        for _ in range(ad.num_layers)]
        return self._ks, self._vs

    @torch.inference_mode()
    def _forward(self, slot: int, toks, pos: int, wlen: int) -> np.ndarray:
        """One window forward of ``slot``'s row at ``pos`` with write
        length ``wlen``; the host logits [vocab] at token ``wlen - 1``."""
        ad = self.adapter
        block = np.zeros((1, self.window), np.int64)
        block[0, :len(toks)] = np.asarray(toks, np.int64)
        pos_v = torch.tensor([pos], dtype=torch.long, device=ad.device)
        wl = torch.tensor([wlen], dtype=torch.long, device=ad.device)
        ks, vs = self._pools()
        caches = [(k[slot:slot + 1], v[slot:slot + 1], pos_v, wl)
                  for k, v in zip(ks, vs)]
        h, _ = ad.call(torch.from_numpy(block).to(ad.device), caches)
        logits = ad.head(h[:, wlen - 1:wlen])[0, -1]
        return logits.float().cpu().numpy()

    # -- proposal ------------------------------------------------------
    def _ensure(self, rid: int) -> Optional[dict]:
        st = self._state.get(rid)
        if st is None:
            if not self._free:
                return None                    # degrade to k=1
            st = {"slot": self._free.pop(), "n": 0}
            self._state[rid] = st
        return st

    def _catch_up(self, st: dict, ids: np.ndarray) -> Optional[np.ndarray]:
        """Feed the confirmed history into the draft cache up to
        ``len(ids)``; returns the logits predicting token ``len(ids)``
        (None when the history overruns the pool). ``n`` advances only
        after each forward, so a failure part-way leaves a consistent
        shorter prefix."""
        L = int(len(ids))
        if L > self.max_len:
            return None
        if st["n"] > L - 1:
            st["n"] = 0                        # history shrank: rebuild
        start = min(st["n"], L - 1)            # re-feed the last token
        out = None
        while start < L:
            w = min(self.window, L - start)
            out = self._forward(st["slot"], ids[start:start + w], start, w)
            start += w
            st["n"] = max(st["n"], start)
        return out

    def propose(self, rid: int, ids: np.ndarray,
                max_tokens: Optional[int] = None) -> np.ndarray:
        """Greedy draft chain: the argmax of the draft model's own
        sequential predictions (NgramProposer.propose's contract)."""
        toks, _ = self._propose(rid, ids, max_tokens, None, None)
        return toks

    def propose_sampled(self, rid: int, ids: np.ndarray,
                        max_tokens: Optional[int], params,
                        rng) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Sampled draft chain for rejection-sampling acceptance: draft
        token j is drawn from the draft distribution q_j
        (``sampling_dist`` under the request's own params and rng), and
        every q_j is returned for the engine's min(1, p/q) test and the
        residual."""
        return self._propose(rid, ids, max_tokens, params, rng)

    def _propose(self, rid, ids, max_tokens, params, rng):
        want = self.max_draft if max_tokens is None \
            else min(int(max_tokens), self.max_draft)
        L = int(len(ids))
        if want < 1 or L < 1 or L >= self.max_len:
            return _EMPTY, []
        st = self._ensure(rid)
        if st is None:
            return _EMPTY, []
        logits = self._catch_up(st, np.asarray(ids, np.int64))
        if logits is None:
            return _EMPTY, []
        draft, qs = [], []
        for j in range(want):
            if params is None:
                t = int(np.argmax(logits))
            else:
                q = sampling_dist(logits, params)
                t = int(rng.choice(q.size, p=q))
                qs.append(q)
            draft.append(t)
            pos = L + j
            if j + 1 >= want or pos >= self.max_len:
                break
            # a speculative feed: it writes at positions >= the
            # confirmed n, which the next catch-up overwrites
            logits = self._forward(st["slot"], [t], pos, 1)
        return np.asarray(draft, np.int64), qs
