"""Continuous-batching serving engine over the static KV-cache decode
path: the paged pool (the default) or the contiguous slot pool.

Counterpart of ``paddle_tpu/serving/engine.py`` ``_ModelAdapter`` and
``ServingEngine``. Each ``step()``:

1. cancels requests past their deadline;
2. admits queued requests into free slots, FCFS; on the paged layout an
   admission also needs its worst-case page span to fit the pool (the
   page reservation, ``PagedKVCache.try_reserve``), so decode never runs
   out of pages. Each admission runs its prompt, padded to its power-of-2
   bucket, through the model at position 0 (the flash-attention
   prefill, ``models/_decode_cache.py``) and samples its first token.
   Paged: the prompt is first matched against the prefix index; matched
   pages are referenced, a partially shared page is copied (COW), and
   only the tail runs, through the paged EXTEND at the match's end,
   which attends over the shared pages; an unmatched prompt runs the
   full prefill in a local ``[1, bucket]`` cache whose k/v are then
   written into the claimed pages (quantized on the int8 path);
3. runs ONE decode forward over ``[max_slots, 1]`` tokens with per-row
   positions (inactive rows pinned to position 0, and on the paged
   layout to trash page 0; their logits are ignored), samples every
   active row on the host, and evicts rows that hit EOS or their length.
   Paged: pages a write crosses into are allocated (or COW'd) before
   the step.

``speculative=True`` swaps step 3 for ONE k-wide verify forward over
``[max_slots, spec_k]`` tokens (``_decode_verify``): each row's block is
its last token and up to ``spec_k - 1`` draft tokens from the n-gram
proposer or a draft model (``spec_decode.py``), written only up to its
per-row length ``wlen``; a greedy row emits the leading run of drafts
that equal the verify's own argmax one position earlier, plus one, so
its tokens are the k=1 decode's; a sampled row (``spec_sampled=True``)
takes drafts by rejection sampling, which keeps the k=1 distribution.
With ``spec_gate`` (the default) a step where no row drafted runs the
k=1 decode instead. ``spec_tune=True`` adds the ``SpecTuner``.

Synchronous API, as in the reference:

    engine = ServingEngine(model, max_slots=8, max_len=256, eos_id=2)
    r1 = engine.submit(prompt, max_new_tokens=32)
    while engine.has_work():
        finished = engine.step()
    print(r1.output_ids, engine.metrics.summary(), engine.paged_stats())

The reference compiles one program per step shape; PyTorch runs
eagerly, so the same shapes are simply launched each step (CUDA graphs
are later work). The KV pools are written in place; page tables,
refcounts and the prefix index stay on the host, and the page table
goes to the device as a copy once per model call. A step that fails
may leave a half-written pool, so it marks the engine broken
(``EngineBroken`` from then on); a failed paged prefill first returns
every page it claimed. ``recover()`` comes with the resilience slice.

Arguments of the reference engine that this slice does not cover are
accepted at their reference defaults and raise ``NotImplementedError``
naming the slice that brings them otherwise.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.nn import functional as TF

from .errors import (DeadlineExceeded, EngineBroken, EngineClosed,
                     EngineIdle, QueueFull, RequestCancelled)
from .metrics import EngineMetrics
from .sampling import SamplingParams, sample_token, sampling_dist
from .scheduler import FIFOScheduler, Request, bucket_for
from .slot_cache import PagedKVCache, SlotKVCache
from .spec_decode import DraftModelProposer, NgramProposer
from .spec_tune import SpecTuner
from ..models._decode_cache import PageTable, per_position, quantize_kv_page

__all__ = ["ServingEngine"]

_MESH = "multi-GPU serving slice"
_CHUNK = "chunked-prefill slice"
_TIER = "KV-tiering slice"
_HOOKS = "observability and fault-hook slice"
# reference-engine argument -> (its reference default, the slice of the
# port that brings it)
_LATER = {
    "mesh": (None, _MESH), "prefill_devices": (0, _MESH),
    "kv_transport": (None, _MESH),
    "prefill_chunk": (None, _CHUNK), "chunk_control": (None, _CHUNK),
    "admission_lookahead": (0, _CHUNK),
    "kv_host_tier": (False, _TIER), "host_tier_pages": (None, _TIER),
    "prefix_store_dir": (None, _TIER),
    "registry": (None, _HOOKS), "flight_recorder": (None, _HOOKS),
    "auditor": (None, _HOOKS), "cancel_probe": (None, _HOOKS),
}


class _ModelAdapter:
    """Uniform view over the causal LMs with a static-cache path: a
    backbone callable taking (ids, caches), a logits head, and the
    cache geometry. Llama only in this slice."""

    def __init__(self, model):
        if not hasattr(model, "llama"):
            raise TypeError(
                f"{type(model).__name__} exposes no static-cache decode "
                "path this engine can drive (expected a LlamaForCausalLM "
                "with a .llama backbone; GPT serving comes with a later "
                "slice of the port)")
        self.model = model
        cfg = model.config
        backbone = model.llama
        self.call = lambda ids, caches, positionwise=False: backbone(
            ids, None, caches, positionwise)
        self.head = model._head
        self.num_layers = len(backbone.layers)
        self.head_dim = cfg.head_dim
        # an nn.Linear or a weight-only Int4Linear / Int8Linear: all
        # have out_features
        kp = backbone.layers[0].self_attn.k_proj
        self.kv_heads = kp.out_features // cfg.head_dim
        self.max_positions = cfg.max_position_embeddings
        w = backbone.embed_tokens.weight
        self.dtype, self.device = w.dtype, w.device


class ServingEngine:
    """Slot-based continuous-batching engine (see module docstring)."""

    def __init__(self, model, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 min_bucket: int = 16,
                 max_queue: Optional[int] = None,
                 time_fn: Callable[[], float] = time.perf_counter,
                 kv_layout: str = "paged",
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_sharing: Optional[bool] = None,
                 speculative: bool = False,
                 spec_k: int = 4,
                 spec_ngram: int = 2,
                 spec_gate: bool = True,
                 spec_proposer: str = "ngram",
                 draft_model=None,
                 spec_sampled: bool = False,
                 spec_tune: bool = False,
                 **reference_only):
        for name, value in reference_only.items():
            if name not in _LATER:
                raise TypeError(
                    f"ServingEngine() got an unexpected keyword argument "
                    f"{name!r}")
            default, later = _LATER[name]
            if value is not default and value != default:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) comes with the {later} "
                    f"of the port")
        if kv_layout not in ("paged", "contiguous"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'contiguous', got "
                f"{kv_layout!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None (model dtype) or 'int8', got "
                f"{kv_dtype!r}")
        if kv_layout == "contiguous" and (
                page_size is not None or num_pages is not None
                or kv_dtype is not None or prefix_sharing is not None):
            raise ValueError(
                "page_size/num_pages/kv_dtype/prefix_sharing only apply "
                "to the paged kv_layout")
        self.adapter = _ModelAdapter(model)
        model.eval()
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or self.adapter.max_positions)
        if self.max_len > self.adapter.max_positions:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's position "
                f"range {self.adapter.max_positions}")
        self.eos_id = eos_id
        if max_queue is not None and max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 or None, got {max_queue}")
        self.max_queue = max_queue
        self.min_bucket = min(int(min_bucket), self.max_len)
        self.paged = kv_layout == "paged"
        ad = self.adapter
        if self.paged:
            if page_size is None:
                # the largest power-of-2 divisor of max_len up to 128
                page_size = 128
                while self.max_len % page_size:
                    page_size //= 2
            self.page_size = int(page_size)
            self.num_pages = num_pages        # None = capacity parity
            self.kv_quant = kv_dtype == "int8"
            self.prefix_sharing = True if prefix_sharing is None \
                else bool(prefix_sharing)
            self.cache = PagedKVCache(
                ad.num_layers, self.max_slots, self.max_len, ad.kv_heads,
                ad.head_dim, ad.dtype, ad.device, page_size=self.page_size,
                num_pages=self.num_pages, quant=self.kv_quant,
                prefix_sharing=self.prefix_sharing)
            # the most requests in flight at once (benchmarks read it)
            self.peak_active_slots = 0
        else:
            self.cache = SlotKVCache(ad.num_layers, self.max_slots,
                                     self.max_len, ad.kv_heads,
                                     ad.head_dim, ad.dtype, ad.device)
        self._init_speculation(speculative, spec_k, spec_ngram, spec_gate,
                               spec_proposer, draft_model, spec_sampled,
                               spec_tune)
        self.scheduler = FIFOScheduler()
        self.metrics = EngineMetrics(self.max_slots, time_fn)
        self._next_rid = 0
        self._step_idx = 0
        self._broken: Optional[str] = None
        self._closed = False

    def _init_speculation(self, speculative, spec_k, spec_ngram, spec_gate,
                          spec_proposer, draft_model, spec_sampled,
                          spec_tune) -> None:
        """The speculative arguments and their validation (reference
        :274-330). Every configured proposer lives as long as the
        engine (the tuner switches between them) and is released in
        step with the slots (``_proposer_release``)."""
        self.speculative = bool(speculative)
        self._tuner = None
        if not self.speculative:
            if spec_k != 4 or spec_ngram != 2 or spec_gate is not True \
                    or spec_proposer != "ngram" or draft_model is not None \
                    or spec_sampled or spec_tune:
                raise ValueError(
                    "spec_k/spec_ngram/spec_gate/spec_proposer/"
                    "draft_model/spec_sampled/spec_tune only apply with "
                    "speculative=True")
            return
        if spec_k < 2:
            raise ValueError(
                f"spec_k must be >= 2 (k includes the k=1 base token), "
                f"got {spec_k}")
        if spec_proposer not in ("ngram", "draft"):
            raise ValueError(
                f"spec_proposer must be 'ngram' or 'draft', got "
                f"{spec_proposer!r}")
        if spec_proposer == "draft" and draft_model is None:
            raise ValueError("spec_proposer='draft' requires draft_model=")
        self.spec_k = int(spec_k)
        self._proposers = {"ngram": NgramProposer(
            ngram=spec_ngram, max_draft=self.spec_k - 1)}
        if draft_model is not None:
            self._proposers["draft"] = DraftModelProposer(
                draft_model, max_slots=self.max_slots,
                max_len=self.max_len, max_draft=self.spec_k - 1)
        self.spec_proposer = spec_proposer
        self.proposer = self._proposers[spec_proposer]
        self.spec_sampled = bool(spec_sampled)
        # a step where no row drafted runs the k=1 decode, which emits
        # the same tokens at 1/k of the verify's work
        self.spec_gate = bool(spec_gate)
        if spec_tune:
            # starts on the configured proposer, probes the others
            self._tuner = SpecTuner(
                k_max=self.spec_k,
                proposers=tuple([spec_proposer] + [
                    k for k in self._proposers if k != spec_proposer]))
        self._spec = {"steps": 0, "gated_steps": 0, "rows": 0,
                      "emitted": 0, "draft_tokens": 0,
                      "accepted_draft_tokens": 0, "draft_faults": 0,
                      "resamples": 0, "draft_s": 0.0,
                      "acc_len_hist": [0] * (self.spec_k + 1)}

    # -- public API ----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue one request; returns its handle (tokens appear on it
        as steps run). ``deadline_s`` (seconds from now, engine clock):
        the request is cancelled at the first step boundary past it,
        with ``finish_reason == "deadline"`` and a typed
        :class:`DeadlineExceeded` in ``Request.error``.

        Typed refusals: :class:`EngineClosed` after ``drain()``,
        :class:`EngineBroken` after a failed step, :class:`QueueFull`
        when ``max_queue`` requests are already waiting."""
        self._check_admission()
        return self.submit_request(self._build_request(
            prompt_ids, max_new_tokens, sampling, deadline_s))

    def submit_request(self, req: Request) -> Request:
        """Enqueue a pre-built Request (the typed admission checks
        apply)."""
        self._check_admission()
        self.scheduler.add(req)
        self.metrics.on_submit(req.rid)
        return req

    def has_work(self) -> bool:
        return self.scheduler.has_pending() or \
            bool(self.cache.active_slots())

    def step(self) -> List[Request]:
        """One engine iteration: admit into free slots (bucketed
        prefill), then one decode step over every occupied slot, then
        evict finished sequences. Returns the requests finished this
        step.

        Typed refusals: :class:`EngineBroken` after a failed step;
        :class:`EngineIdle` when there is no queued or in-flight work
        (guard loops with ``has_work()``)."""
        if self._broken:
            raise EngineBroken(self._broken)
        if not self.has_work():
            raise EngineIdle()
        step_idx = self._step_idx
        self._step_idx += 1
        finished: List[Request] = []
        try:
            with torch.inference_mode():
                self._step_inner(finished)
        except Exception as e:
            self._broken = f"step #{step_idx}: {type(e).__name__}: {e}"
            raise
        return finished

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drive step() until the queue and every slot drain."""
        done: List[Request] = []
        steps = 0
        while self.has_work():
            done.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return done

    def drain(self, max_steps: Optional[int] = None) -> List[Request]:
        """Graceful shutdown: refuse new submissions and serve the queue
        plus every in-flight slot to completion. If ``max_steps`` runs
        out first, or a step fails (the engine is then broken), what
        remains is cancelled (``finish_reason == "cancelled"``, a
        :class:`RequestCancelled` naming the cause in ``Request.error``,
        chained to the failed step's exception) instead of being
        stranded. Returns every request finished or
        cancelled during the drain."""
        self._closed = True
        done: List[Request] = []
        steps = 0
        last_err: Optional[BaseException] = None
        while self.has_work():
            if max_steps is not None and steps >= max_steps:
                cutoff = "drain cutoff"
            elif self._broken:
                cutoff = f"drain on broken engine ({self._broken})"
            else:
                try:
                    done.extend(self.step())
                except Exception as e:   # the engine is broken now: the
                    last_err = e         # next pass cancels the rest
                steps += 1
                continue
            for req in self.scheduler.drain():
                self._cancel(req, cutoff, last_err)
                self.metrics.on_finished(req.rid)
                done.append(req)
            for s in self.cache.active_slots():
                req = self.cache.slots[s]
                self._cancel(req, cutoff, last_err)
                self._evict(s, req, done)
            break
        self._proposer_retain(())          # a drained engine holds none
        return done

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Cancel one request (queued or in flight; its pages return to
        the pool); False if it already finished. Delivered tokens stay on
        the handle."""
        if req.finished:
            return False
        if not self.scheduler.remove(req):
            if req.slot is None or self.cache.slots[req.slot] is not req:
                return False
            self.cache.release(req.slot)
            req.slot = None
        req.finished, req.finish_reason = True, reason
        req.error = RequestCancelled(req.rid, reason)
        self.metrics.on_finished(req.rid)
        self._proposer_release(req.rid)
        return True

    def spec_stats(self) -> dict:
        """Speculative-decoding snapshot (raises on a non-speculative
        engine): verify steps, per-row emission totals, draft proposal
        and acceptance counts, the accepted-length histogram."""
        if not self.speculative:
            raise RuntimeError("spec_stats() on a non-speculative engine")
        s = dict(self._spec)
        s["acc_len_hist"] = list(s["acc_len_hist"])
        s["k"] = self.spec_k
        s["proposer"] = self.spec_proposer
        s["sampled"] = self.spec_sampled
        s["draft_hit_rate"] = (
            s["accepted_draft_tokens"] / s["draft_tokens"]
            if s["draft_tokens"] else 0.0)
        s["accepted_per_step"] = (
            s["emitted"] / s["rows"] if s["rows"] else 0.0)
        if self._tuner is not None:
            s["tuner"] = self._tuner.snapshot()
        return s

    def _proposer_release(self, rid: int) -> None:
        """Release one rid's draft state from every configured proposer
        (the tuner may have moved a request between kinds)."""
        if self.speculative:
            for p in self._proposers.values():
                p.release(rid)

    def _proposer_retain(self, rids) -> None:
        if self.speculative:
            keep = list(rids)
            for p in self._proposers.values():
                p.retain(keep)

    def paged_stats(self) -> dict:
        """Paged-pool snapshot (raises on a contiguous engine): the
        cache's page, prefix and COW counters, the most requests in
        flight at once, and the prefix hit rate."""
        if not self.paged:
            raise RuntimeError("paged_stats() on a contiguous engine")
        s = self.cache.stats()
        s["peak_active_slots"] = self.peak_active_slots
        s["prefix_hit_rate"] = (
            s["prefix_hit_tokens"] / s["prefix_lookup_tokens"]
            if s["prefix_lookup_tokens"] else 0.0)
        return s

    def recover(self):
        raise NotImplementedError(
            "ServingEngine.recover() comes with the resilience slice of "
            "the port")

    # -- admission -----------------------------------------------------
    def _check_admission(self) -> None:
        if self._closed:
            raise EngineClosed()
        if self._broken:
            raise EngineBroken(self._broken)
        if self.max_queue is not None \
                and self.scheduler.depth >= self.max_queue:
            raise QueueFull(self.scheduler.depth, self.max_queue)

    def _build_request(self, prompt_ids, max_new_tokens: int = 16,
                       sampling: Optional[SamplingParams] = None,
                       deadline_s: Optional[float] = None) -> Request:
        """Validate inputs and build a Request without enqueuing it."""
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.detach().cpu().numpy()
        ids = np.asarray(prompt_ids).astype(np.int64)
        if ids.ndim == 2 and ids.shape[0] == 1:   # [1, T] batch-of-one
            ids = ids[0]
        if ids.ndim != 1:
            raise ValueError(
                f"submit() takes a single prompt sequence; got shape "
                f"{ids.shape}. Call submit() once per request.")
        if ids.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if ids.size + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt ({ids.size}) + max_new_tokens "
                f"({max_new_tokens}) - 1 exceeds max_len {self.max_len}")
        sampling = sampling or SamplingParams()
        sampling.validate()
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {deadline_s}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=ids,
                      max_new_tokens=int(max_new_tokens),
                      sampling=sampling,
                      deadline=(self.metrics.now() + deadline_s
                                if deadline_s is not None else None))
        req._rng = np.random.RandomState(
            sampling.seed if sampling.seed is not None
            else 0x5EED + req.rid)
        return req

    # -- one iteration -------------------------------------------------
    def _step_inner(self, finished: List[Request]) -> None:
        self._expire_deadlines(finished)
        claim = unclaim = None
        if self.paged:
            # admission is gated by FREE PAGES as well as free slots: the
            # claim reserves the request's worst-case page span
            def claim(req):
                return self.cache.try_reserve(
                    req, req.prompt, req.prompt_len + req.max_new_tokens)
            unclaim = self.cache.cancel_reservation
        pairs = self.scheduler.admissions(self.cache.free_slots(),
                                          claim=claim, unclaim=unclaim)
        for i, (slot, req) in enumerate(pairs):
            try:
                self._prefill(slot, req)
            except Exception:
                # admissions() popped the whole batch: what was not yet
                # admitted goes back to the queue head in FCFS order,
                # its page reservation returned
                for _, later in reversed(pairs[i + 1:]):
                    if self.paged:
                        self.cache.cancel_reservation(later)
                    self.scheduler.requeue(later)
                if req.slot is None:
                    if self.paged:
                        self.cache.cancel_reservation(req)
                    self.scheduler.requeue(req)
                raise
            if req.finished:
                self._evict(slot, req, finished)
        active = self.cache.active_slots()
        if active:
            if self.speculative:
                self._decode_verify(active, finished)
            else:
                self._decode(active, finished)
        self.metrics.on_step(len(active))
        if self.paged:
            self.peak_active_slots = max(self.peak_active_slots,
                                         len(active))

    def _prefill(self, slot: int, req: Request) -> None:
        """Run the request's bucketed prefill into its slot and sample
        its first token (TTFT)."""
        self.metrics.on_first_prefill(req.rid)
        if self.paged:
            logits = self._prefill_paged(slot, req)
        else:
            logits = self._prefill_raw(slot, req.prompt)
        self.cache.assign(slot, req)
        req.slot = slot
        tok = sample_token(logits, req.sampling, req._rng)
        req.out_tokens.append(tok)
        self.metrics.on_token(req.rid)
        self._is_finished(req, tok)

    def _prefill_raw(self, slot: int, ids: np.ndarray) -> np.ndarray:
        """Write ``ids``'s k/v into positions ``0..bucket-1`` of the slot
        row (the padded tail is garbage the causal mask hides and each
        decode step overwrites before attending) and return the host
        logits at the last real token."""
        n = int(ids.shape[0])
        bucket = bucket_for(n, self.min_bucket, self.max_len)
        # views of the slot's rows: the prefill writes the pool in place
        caches = [(k[slot:slot + 1, :bucket], v[slot:slot + 1, :bucket], 0)
                  for k, v in zip(self.cache.ks, self.cache.vs)]
        return self._logits(self._padded(ids, 0, bucket), n, caches)[0]

    def _padded(self, ids: np.ndarray, start: int, bucket: int):
        """``ids[start:]`` zero-padded to ``[1, bucket]`` on the device."""
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(ids) - start] = ids[start:]
        return torch.from_numpy(padded).to(self.adapter.device)

    def _logits(self, ids, n: int, caches):
        """One model call over ``ids`` [1, bucket] with ``caches``: the
        host logits at token ``n - 1`` and the new caches."""
        ad = self.adapter
        h, new_caches = ad.call(ids, caches)
        logits = ad.head(h[:, n - 1:n])[0, -1]
        return logits.float().cpu().numpy(), new_caches

    def _prefill_paged(self, slot: int, req: Request) -> np.ndarray:
        """The paged admission (reference ``_prefill_raw``'s paged
        branch): consume the reservation into the slot's page table, run
        the COW copies, then the full prefill (nothing matched) or the
        extend over the shared pages, and index the prompt's full pages.
        Any failure after the claim returns every page
        (``abort_sequence``)."""
        cache = self.cache
        ids = req.prompt
        n = int(ids.shape[0])
        try:
            # same-wave sharing: earlier admissions of this batch have
            # registered their pages since the claim
            cache.refresh_reservation(req, ids)
            start, copies = cache.begin_sequence(slot, req, ids)
            self._run_copies(copies)
            bucket = bucket_for(n - start, self.min_bucket, self.max_len)
            padded = self._padded(ids, start, bucket)
            row = cache.page_table[slot]
            if start == 0:
                npg = -(-bucket // cache.page_size)
                logits = self._paginated_prefill(padded, n,
                                                 row[:npg].copy())
            else:
                logits = self._extend(padded, start, n - start,
                                      row[None].copy())
            cache.register_prefix(slot, ids)
            return logits
        except Exception:
            cache.abort_sequence(slot, req)
            raise

    def _paginated_prefill(self, padded, n: int, page_ids: np.ndarray):
        """Full-prompt paged prefill: run the prompt through a local
        ``[1, bucket]`` static cache (the contiguous prefill's flash
        route at the same S), then write its k/v into ``page_ids``
        (quantized on the int8 path); a page id past the allocated span
        is trash page 0."""
        ad, cache = self.adapter, self.cache
        bucket = padded.shape[1]
        shape = (1, bucket, ad.kv_heads, ad.head_dim)
        local = [(torch.zeros(shape, dtype=ad.dtype, device=ad.device),
                  torch.zeros(shape, dtype=ad.dtype, device=ad.device), 0)
                 for _ in range(ad.num_layers)]
        logits, new_caches = self._logits(padded, n, local)
        P = cache.page_size
        npg = len(page_ids)
        pid = torch.from_numpy(page_ids).to(ad.device)

        def paginate(c):
            c = TF.pad(c, (0, 0, 0, 0, 0, npg * P - bucket))
            return c.reshape(npg, P, *c.shape[2:])
        for i, (kc, vc, _) in enumerate(new_caches):
            kpg, vpg = paginate(kc), paginate(vc)
            if self.kv_quant:
                kq, ksc = quantize_kv_page(kpg)
                vq, vsc = quantize_kv_page(vpg)
                cache.ks[i][pid], cache.kss[i][pid] = kq, ksc
                cache.vs[i][pid], cache.vss[i][pid] = vq, vsc
            else:
                cache.ks[i][pid] = kpg
                cache.vs[i][pid] = vpg
        return logits

    def _paged_caches(self, table, pos):
        """Per-layer paged cache tuples over one device copy of
        ``table`` (a ``PageTable``: the layers share its indices);
        scales None on the model-dtype path."""
        c = self.cache
        tab = PageTable(torch.from_numpy(table).to(self.adapter.device))
        return [(k, v, c.kss[i] if c.kss else None,
                 c.vss[i] if c.vss else None, tab, pos)
                for i, (k, v) in enumerate(zip(c.ks, c.vs))]

    def _extend(self, padded, start: int, tail: int, table: np.ndarray):
        """Shared-prefix tail prefill: the tail runs through the paged
        cache path at position ``start``, attending over the shared
        pages through the slot's table and writing its own k/v through
        it (bucket padding past the table goes to the trash page)."""
        return self._logits(padded, tail,
                            self._paged_caches(table, start))[0]

    def _run_copies(self, copies) -> None:
        """COW page copies on the device, before any program reads the
        pages: ``pool[dst] = pool[src]`` for every layer's k/v (and
        scale) pool."""
        c = self.cache
        for src, dst in copies:
            for pool in (*c.ks, *c.vs, *c.kss, *c.vss):
                pool[dst] = pool[src]

    def _decode(self, active, finished: List[Request]) -> None:
        """The k=1 decode step over every slot (reference
        ``_decode_plain``)."""
        ad = self.adapter
        toks = np.zeros((self.max_slots, 1), np.int64)
        pos = np.zeros((self.max_slots,), np.int64)
        copies = []
        for s in active:
            req = self.cache.slots[s]
            toks[s, 0] = req.out_tokens[-1]
            pos[s] = req.next_pos
            if self.paged:
                # the write may cross into a new page (allocate) or a
                # shared one (COW): resolve it BEFORE the step
                c = self.cache.ensure_decode_page(s, req.next_pos)
                if c is not None:
                    copies.append(c)
        pos_dev = torch.from_numpy(pos).to(ad.device)
        if self.paged:
            self._run_copies(copies)
            # inactive rows read and write trash page 0 at position 0
            table = np.zeros_like(self.cache.page_table)
            table[active] = self.cache.page_table[active]
            caches = self._paged_caches(table, pos_dev)
        else:
            caches = [(k, v, pos_dev)
                      for k, v in zip(self.cache.ks, self.cache.vs)]
        h, _ = ad.call(torch.from_numpy(toks).to(ad.device), caches)
        logits = ad.head(h[:, -1:])[:, -1].float().cpu().numpy()
        for s in active:
            req = self.cache.slots[s]
            tok = sample_token(logits[s], req.sampling, req._rng)
            req.out_tokens.append(tok)
            self.metrics.on_token(req.rid)
            if self._is_finished(req, tok):
                self._evict(s, req, finished)

    # -- speculative decoding ------------------------------------------
    def _decode_verify(self, active, finished: List[Request]) -> None:
        """One speculative step (reference ``_decode_verify``): draft up
        to k-1 tokens per eligible row, score all k positions in ONE
        k-wide forward (``_verify``), and emit each row's accepted
        tokens (``_emit_verified``).

        A row without a draft (no n-gram hit, a sampled row without
        ``spec_sampled``, the tuner says off, one token of budget left)
        runs at write length 1 inside the same forward. Draft tokens
        the verify rejects have written k/v past the row's next write
        position: the causal mask hides them until a later step
        overwrites them, so the only rollback is the pages claimed past
        the accepted tokens (paged). A failed draft proposal is
        contained to its row (``_on_draft_fault``)."""
        K = self.spec_k
        toks = np.zeros((self.max_slots, K), np.int64)
        pos = np.zeros((self.max_slots,), np.int64)
        wlen = np.zeros((self.max_slots,), np.int64)
        row_kind = {}          # slot -> proposer kind that drafted
        row_draft = {}         # slot -> draft tokens (sampled rows)
        row_qs = {}            # slot -> per-draft q ([] = point mass)
        attempted = {}         # slot -> (klass, kind) fed to the tuner
        for s in active:
            req = self.cache.slots[s]
            toks[s, 0] = req.out_tokens[-1]
            pos[s] = req.next_pos
            n = 1
            sampled = req.sampling.temperature > 0
            klass = "sampled" if sampled else "greedy"
            kind = self.spec_proposer
            k_cap = K
            if self._tuner is not None:
                k_cap, kind = self._tuner.decide(klass)
            # a draft longer than the remaining budget is wasted work
            # and would write past the admission reservation
            budget = req.max_new_tokens - len(req.out_tokens)
            want = min(K - 1, budget - 1, k_cap - 1)
            if want > 0 and kind is not None \
                    and (not sampled or self.spec_sampled):
                prop = self._proposers[kind]
                attempted[s] = (klass, kind)
                draft, qs = (), []
                t0 = self.metrics.now()
                try:
                    if sampled and isinstance(prop, DraftModelProposer):
                        draft, qs = prop.propose_sampled(
                            req.rid, req.full_ids, want, req.sampling,
                            req._rng)
                    else:
                        # a point-mass proposal (qs=[] says so)
                        draft = prop.propose(req.rid, req.full_ids, want)
                except Exception as exc:
                    draft, qs = (), []
                    self._on_draft_fault(s, req, prop, exc)
                finally:
                    dt = self.metrics.now() - t0
                    self._spec["draft_s"] += dt
                    self.metrics.on_draft(dt)
                if len(draft):
                    toks[s, 1:1 + len(draft)] = draft
                    n = 1 + len(draft)
                    row_kind[s] = kind
                    if sampled:
                        row_draft[s], row_qs[s] = draft, qs
                    self._spec["draft_tokens"] += len(draft)
            wlen[s] = n
        if self.spec_gate and all(int(wlen[s]) == 1 for s in active):
            # no row drafted: the k=1 decode emits the same tokens (the
            # same logits row, the same per-request RNG stream) at 1/k
            # of the verify's work; no page state was touched yet
            n_rows = len(active)
            self._decode(active, finished)
            self._spec["gated_steps"] += 1
            self._spec["rows"] += n_rows
            self._spec["emitted"] += n_rows
            self._spec["acc_len_hist"][1] += n_rows
            # rows that tried to draft and came back empty read as
            # accepted length 1 to the tuner
            self._tuner_step(attempted, {s: 1 for s in attempted})
            return
        copies = []
        try:
            if self.paged:
                for s in active:
                    copies += self.cache.ensure_decode_range(
                        s, self.cache.slots[s].next_pos, int(wlen[s]))
                self._run_copies(copies)
            logits, greedy, acc = self._verify(active, toks, pos, wlen)
        except Exception:
            # nothing was emitted, but ensure_decode_range claimed every
            # page the k-wide window touches: return those past each
            # row's next write position before re-raising
            if self.paged:
                for s in active:
                    req = self.cache.slots[s]
                    if req is not None:
                        self.cache.rollback_speculation(s, req.next_pos)
            raise
        emitted_by_slot = {}
        try:
            for s in active:
                req = self.cache.slots[s]
                emitted = self._emit_verified(
                    s, req, greedy[s], int(acc[s]), logits[s],
                    draft=row_draft.get(s), qs=row_qs.get(s))
                emitted_by_slot[s] = emitted
                self._spec["rows"] += 1
                self._spec["emitted"] += emitted
                self._spec["accepted_draft_tokens"] += emitted - 1
                self._spec["acc_len_hist"][min(emitted, K)] += 1
                if self.paged and not req.finished:
                    # pages past the next write position hold only
                    # rejected drafts (a finished row releases all)
                    self.cache.rollback_speculation(s, req.next_pos)
                if req.finished:
                    self._evict(s, req, finished)
        except Exception:
            # rows not yet emitted hold over-claimed pages: the same
            # debt as above (tokens already appended stay appended)
            if self.paged:
                for s in active:
                    req = self.cache.slots[s]
                    if req is not None and not req.finished:
                        self.cache.rollback_speculation(s, req.next_pos)
            raise
        self._spec["steps"] += 1
        # every attempted row's accepted length (an empty draft is 1)
        self._tuner_step(attempted, {s: emitted_by_slot.get(s, 1)
                                     for s in attempted})

    def _verify(self, active, toks: np.ndarray, pos: np.ndarray,
                wlen: np.ndarray):
        """The k-wide verify forward (reference ``_verify_fn``, run
        eagerly): every row advances up to k tokens at its own position,
        token ``j`` writing only when ``j < wlen``; the norms, linears
        and LM head run one position at a time (``per_position``), the
        attention over the whole block. Inactive rows are
        pinned to position 0, write length 0 and (paged) trash page 0,
        and their logits are zeroed. On the device: the argmax at every
        position, and the accepted length, 1 plus the leading run of
        drafts equal to the argmax one position earlier (a cumprod).
        Returns host (logits [S, k, vocab] f32, greedy [S, k],
        accepted [S]); one copy of the logits and one of greedy and
        accepted a step."""
        ad = self.adapter
        dev = ad.device
        K = toks.shape[1]
        act = np.zeros((self.max_slots,), bool)
        act[active] = True
        pos_dev = torch.from_numpy(np.where(act, pos, 0)).to(dev)
        wl_dev = torch.from_numpy(np.where(act, wlen, 0)).to(dev)
        toks_dev = torch.from_numpy(toks).to(dev)
        if self.paged:
            table = np.zeros_like(self.cache.page_table)
            table[active] = self.cache.page_table[active]
            caches = [c + (wl_dev,)
                      for c in self._paged_caches(table, pos_dev)]
        else:
            caches = [(k, v, pos_dev, wl_dev)
                      for k, v in zip(self.cache.ks, self.cache.vs)]
        # one position at a time through the norms, linears and the LM
        # head: each position then has the bits of the k=1 decode's
        # [S, 1] step, so greedy acceptance gives its tokens
        h, _ = ad.call(toks_dev, caches, positionwise=True)
        act_dev = torch.from_numpy(act).to(dev)
        logits = torch.where(act_dev[:, None, None],
                             per_position(ad.head, h).float(),
                             0.0)                         # [S, k, vocab]
        g = logits.argmax(dim=-1)                         # [S, k]
        ok = (toks_dev[:, 1:] == g[:, :-1]) & (
            torch.arange(1, K, device=dev)[None, :] < wl_dev[:, None])
        acc = 1 + torch.cumprod(ok.long(), dim=1).sum(dim=1)
        acc = torch.where(act_dev, acc, 0)
        ga = torch.cat([g, acc[:, None]], dim=1).cpu().numpy()
        return logits.cpu().numpy(), ga[:, :K], ga[:, K]

    def _emit_verified(self, slot: int, req: Request,
                       greedy_row: np.ndarray, acc: int,
                       logits_row: np.ndarray, draft=None,
                       qs=None) -> int:
        """Apply one row's verify result; returns the tokens emitted.
        Greedy rows: the first ``acc`` argmax tokens, stopping AT an EOS
        as sequential decode does. Undrafted sampled rows: one token
        sampled from position 0, on the request's RNG stream, as the k=1
        decode samples it. Drafted sampled rows (``spec_sampled``):
        rejection sampling: draft j is accepted with probability
        min(1, p_j(t) / q_j(t)), p_j the target's ``sampling_dist`` at
        that position and q_j the draft's (a point mass for n-gram
        drafts); the first rejection emits one token from the
        normalized residual max(p - q, 0) and drops the rest; if every
        draft survives, a bonus token is sampled from the position
        after the draft. Each emitted token is then distributed as
        sequential sampling from p (Leviathan et al.)."""
        if req.sampling.temperature > 0:
            sp, rng = req.sampling, req._rng
            if draft is None or len(draft) == 0:
                tok = sample_token(logits_row[0], sp, rng)
                req.out_tokens.append(tok)
                self.metrics.on_token(req.rid)
                self._is_finished(req, tok)
                return 1
            emitted = 0
            for j in range(len(draft)):
                t = int(draft[j])
                p = sampling_dist(logits_row[j], sp)
                pt = float(p[t])
                qt = float(qs[j][t]) if qs else 1.0
                if qt > 0.0 and pt > 0.0 \
                        and float(rng.uniform()) < min(1.0, pt / qt):
                    req.out_tokens.append(t)
                    self.metrics.on_token(req.rid)
                    emitted += 1
                    if self._is_finished(req, t):
                        return emitted
                    continue
                # first rejection: one corrective token from the residual
                if qs:
                    res = np.maximum(p - qs[j], 0.0)
                else:
                    res = p.copy()
                    res[t] = 0.0
                tot = res.sum()
                # q >= p everywhere: the rejection had measure zero
                res = p if tot <= 0.0 else res / tot
                tok = int(rng.choice(res.size, p=res))
                req.out_tokens.append(tok)
                self.metrics.on_token(req.rid)
                emitted += 1
                self._spec["resamples"] += 1
                self._is_finished(req, tok)
                return emitted
            # every draft accepted: the verify computed the next
            # position's logits too, the bonus token
            tok = sample_token(logits_row[len(draft)], sp, rng)
            req.out_tokens.append(tok)
            self.metrics.on_token(req.rid)
            emitted += 1
            self._is_finished(req, tok)
            return emitted
        emitted = 0
        for j in range(acc):
            tok = int(greedy_row[j])
            req.out_tokens.append(tok)
            self.metrics.on_token(req.rid)
            emitted += 1
            if self._is_finished(req, tok):
                break              # accepted tokens past an EOS never show
        return emitted

    def _on_draft_fault(self, slot: int, req: Request, proposer,
                        exc: Exception) -> None:
        """Contain a failed draft proposal to its row for this step: the
        row falls back to k=1. A draft model's failure may have come
        part-way through its in-place pool writes, so that proposer is
        reset whole (its pools are allocated again); the n-gram
        proposer's index is derived from confirmed history, so the rid
        is unwound. ``draft_faults`` counts it."""
        if isinstance(proposer, DraftModelProposer):
            proposer.reset()
        else:
            proposer.unwind(req.rid)
        self._spec["draft_faults"] += 1

    def _tuner_step(self, attempted: dict, accepted: dict) -> None:
        """Feed one step's accepted lengths to the tuner and advance its
        clock (no-op without ``spec_tune``)."""
        if self._tuner is None:
            return
        for s, (klass, kind) in attempted.items():
            self._tuner.observe(klass, kind, accepted.get(s, 1))
        self._tuner.on_step()

    # -- bookkeeping ---------------------------------------------------
    def _is_finished(self, req: Request, tok: int) -> bool:
        if self.eos_id is not None and tok == self.eos_id:
            req.finished, req.finish_reason = True, "eos"
        elif len(req.out_tokens) >= req.max_new_tokens:
            req.finished, req.finish_reason = True, "length"
        return req.finished

    def _evict(self, slot: int, req: Request,
               finished: List[Request]) -> None:
        self.cache.release(slot)
        req.slot = None
        finished.append(req)
        self.metrics.on_finished(req.rid)
        self._proposer_release(req.rid)

    @staticmethod
    def _cancel(req: Request, reason: str,
                cause: Optional[BaseException] = None) -> None:
        req.finished, req.finish_reason = True, "cancelled"
        req.error = RequestCancelled(req.rid, reason)
        req.error.__cause__ = cause

    def _expire_deadlines(self, finished: List[Request]) -> None:
        """Cancel queued and in-flight requests past their deadline
        (step-boundary sweep)."""
        now = self.metrics.now()
        for req in self.scheduler.expire(now):
            req.finished, req.finish_reason = True, "deadline"
            req.error = DeadlineExceeded(req.rid, "expired while queued")
            self.metrics.on_finished(req.rid)
            finished.append(req)
        for s in self.cache.active_slots():
            req = self.cache.slots[s]
            if req.deadline is not None and now > req.deadline:
                req.finished, req.finish_reason = True, "deadline"
                req.error = DeadlineExceeded(
                    req.rid, f"expired in slot {s} after "
                             f"{len(req.out_tokens)} token(s)")
                self._evict(s, req, finished)
