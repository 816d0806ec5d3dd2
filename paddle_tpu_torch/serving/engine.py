"""Continuous-batching serving engine over the static KV-cache decode
path: the paged pool (the default) or the contiguous slot pool.

Counterpart of ``paddle_tpu/serving/engine.py`` ``_ModelAdapter`` and
``ServingEngine``. Each ``step()``:

1. cancels requests past their deadline, and requests whose client went
   away (``Request.cancel_requested`` or the ``cancel_probe``);
2. admits queued requests into free slots, FCFS (``admission_lookahead``
   may pass over that many blocked requests); on the paged layout an
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
3. with ``prefill_chunk`` (chunked prefill), a prompt longer than the
   step's prefill budget (one chunk; ``chunk_control`` scales it) is
   admitted into the PREFILLING state instead (slot leased, pages
   claimed) and advances one chunk a step from the head of the chunk
   FIFO, next to the decode: the chunk runs at its start position
   through the einsum cache attention (a ``[1, chunk]`` forward on the
   slot's row, write-masked past the prompt; paged: the extend at a
   mid-prompt start), and the final chunk samples the first token;
4. runs ONE decode forward over ``[max_slots, 1]`` tokens with per-row
   positions (inactive and PREFILLING rows pinned to position 0, and on
   the paged layout to trash page 0; their logits are ignored), samples
   every active row on the host, and evicts rows that hit EOS or their
   length. Paged: pages a write crosses into are allocated (or COW'd)
   before the step.

``speculative=True`` swaps step 4 for ONE k-wide verify forward over
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
goes to the device as a copy once per model call.

Resilience. The pools are written in place, so EVERY failed step marks
the engine broken (the reference does so on its donated-pool path;
its undonated CPU flavour, which may retry a step, has no counterpart
here): ``step()`` and ``submit()`` raise ``EngineBroken`` until
``recover()``, which keeps the device pools but rebuilds the host state
(slot table; on the paged layout free list, refcounts, page table and
prefix index) and writes every in-flight request's KV again, in
admission order: its prompt by its admission's route, its delivered
tokens by decode forwards, so the pools hold the failed run's bits (the
greedy replay checked and counted); decoding then resumes where it
stopped. Requests a failed step finished are handed back once (by the
next ``step()``, ``recover()`` or ``drain()``). ``recover()`` covers
failures raised on the host (the fault points of
``resilience.faults``, a Python error mid-step); a CUDA error that
poisons the context cannot be recovered in-process and is not caught.
Fault points: ``serving.step.decode``, ``serving.decode.verify``,
``serving.spec.draft``, ``serving.spec.resample``,
``serving.step.prefill``, ``serving.prefill.paged``,
``serving.prefill.chunk``, ``serving.kv.demote`` and
``serving.kv.promote``. A request admitted with tokens already
delivered (``adopt()``, or requeued by a failed admission) takes the
same route: its prompt's prefill, then its tokens by decode forwards
(``_resume``).

KV host tier (``kv_host_tier=True``, ``host_tier_pages``,
``prefix_store_dir``; paged layout with prefix sharing): the reclaim
demotes cold prefix pages to host RAM (page-locked on the card, and
written through to a persistent store under ``prefix_store_dir``)
instead of destroying them; a prompt that matches a demoted page gets a
fresh device page, and the payload is installed there (one H2D copy,
then a slice write per layer, ``_stage_promotions``) before its extend
runs. The tier outlives the cache: ``recover()`` parks the dying index's
device pages in it and the rebuilt cache matches them again, and a new
engine over the same ``prefix_store_dir`` starts warm.

Observability: the ``ptpu_serving_*`` and ``ptpu_kv_*`` families of the
``registry`` (the process default unless given), the spans
``serving.step``, ``serving.prefill``, ``serving.chunk_prefill``,
``serving.kv_promote``, ``serving.decode`` and ``serving.verify``, a
flight-recorder record per step and a dump when a step raises, an
optional ``auditor`` (a ``resilience.ConservationLedger``) told of every
submission and of every delivery at the external boundaries (``step``,
``recover``, ``drain``, ``cancel``), and an optional watchtower
(``observability.Watchtower.attach_engine``), whose counter each
successful step bumps.

Arguments of the reference engine that this port does not cover yet
(the multi-GPU slice: ``mesh``, ``prefill_devices``, ``kv_transport``)
are accepted at their reference defaults and raise
``NotImplementedError`` naming the slice otherwise.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch
from torch.nn import functional as TF

from ..observability import default_recorder, default_registry, span
from ..resilience.faults import InjectedFault, maybe_fail
from .errors import (DeadlineExceeded, EngineBroken, EngineClosed,
                     EngineIdle, QueueFull, RequestCancelled)
from .kv_tier import HostPageTier, PersistentPrefixStore
from .metrics import EngineMetrics
from .sampling import SamplingParams, sample_token, sampling_dist
from .scheduler import FIFOScheduler, Request, bucket_for
from .slot_cache import PagedKVCache, SlotKVCache
from .spec_decode import DraftModelProposer, NgramProposer
from .spec_tune import SpecTuner
from ..models._decode_cache import PageTable, per_position, quantize_kv_page

__all__ = ["ServingEngine"]

_MESH = "multi-GPU serving slice"
# reference-engine argument -> (its reference default, the slice of the
# port that brings it)
_LATER = {
    "mesh": (None, _MESH), "prefill_devices": (0, _MESH),
    "kv_transport": (None, _MESH),
}


class _ModelAdapter:
    """Uniform view over the causal LMs with a static-cache path
    (reference :80-125): a backbone callable taking (ids, caches,
    positionwise), a logits head, and the cache geometry, for a
    ``LlamaForCausalLM`` (``.llama``) or a ``GPTForCausalLM``
    (``.gpt``). Past this class the engine reads no model family's
    names."""

    def __init__(self, model):
        self.model = model
        cfg = model.config
        # the projections may be nn.Linear or a weight-only Int4Linear /
        # Int8Linear: all have out_features
        if hasattr(model, "llama"):
            backbone = model.llama
            self.call = lambda ids, caches, positionwise=False: backbone(
                ids, None, caches, positionwise)
            self.num_layers = len(backbone.layers)
            kv_width = backbone.layers[0].self_attn.k_proj.out_features
            self.max_positions = cfg.max_position_embeddings
            w = backbone.embed_tokens.weight
        elif hasattr(model, "gpt"):
            backbone = model.gpt
            self.call = lambda ids, caches, positionwise=False: backbone(
                ids, caches, positionwise)
            self.num_layers = len(backbone.blocks)
            kv_width = backbone.blocks[0].qkv.out_features // 3
            self.max_positions = cfg.max_seq_len
            w = backbone.wte.weight
        else:
            raise TypeError(
                f"{type(model).__name__} exposes no static-cache decode "
                "path this engine can drive (expected a .llama or .gpt "
                "backbone with a (k, v, pos) cache forward)")
        self.head = model._head
        self.head_dim = cfg.head_dim
        self.kv_heads = kv_width // cfg.head_dim
        self.dtype, self.device = w.dtype, w.device


class ServingEngine:
    """Slot-based continuous-batching engine (see module docstring)."""

    def __init__(self, model, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 min_bucket: int = 16,
                 max_queue: Optional[int] = None,
                 time_fn: Callable[[], float] = time.perf_counter,
                 registry=None, flight_recorder=None,
                 auditor=None,
                 cancel_probe: Optional[Callable] = None,
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
                 prefill_chunk: Optional[int] = None,
                 chunk_control=None,
                 admission_lookahead: int = 0,
                 kv_host_tier: bool = False,
                 host_tier_pages: Optional[int] = None,
                 prefix_store_dir: Optional[str] = None,
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
        self._init_chunking(prefill_chunk, chunk_control,
                            admission_lookahead)
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
        self.paged = kv_layout == "paged"
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
            # the most requests in flight at once (benchmarks read it)
            self.peak_active_slots = 0
        self._init_tier(kv_host_tier, host_tier_pages, prefix_store_dir)
        self.cache = self._new_cache()
        self._init_speculation(speculative, spec_k, spec_ngram, spec_gate,
                               spec_proposer, draft_model, spec_sampled,
                               spec_tune)
        self.scheduler = FIFOScheduler()
        self.registry = registry if registry is not None \
            else default_registry()
        # `is None`, not truthiness: an EMPTY FlightRecorder is falsy
        # (it has __len__)
        self.recorder = flight_recorder if flight_recorder is not None \
            else default_recorder()
        self.metrics = EngineMetrics(self.max_slots, time_fn,
                                     registry=self.registry)
        self._next_rid = 0
        self._step_idx = 0
        # set when a step fails (its in-place KV writes may be half
        # done); recover() clears it
        self._broken: Optional[str] = None
        self._closed = False
        # requests that reached a terminal state inside a FAILED step
        # (deadline sweep, a decode finisher evicted before the raise)
        # or that recover() found finished in a slot: they surface
        # through the next successful step()/recover()/drain() exactly
        # once. The list survives a recover() that itself fails.
        self._undelivered: List[Request] = []
        # admissions so far: each request's place in the admission
        # order, which recover() replays
        self._admissions = 0
        # optional conservation auditor (on_submitted(req) /
        # on_delivered(req, via)), called at the EXTERNAL delivery
        # boundaries only, so a ledger sees exactly what callers see
        self.auditor = auditor
        # optional liveness callback(req) -> bool (True = the client is
        # gone), checked at the step-boundary sweep and mid-prefill,
        # after the request's own cancel_requested flag
        self.cancel_probe = cancel_probe
        self._in_drain = False
        # an observability.Watchtower installs itself here
        # (attach_engine); the step bumps its counter, nothing else
        self._watchtower = None
        self._init_families()

    def _init_chunking(self, prefill_chunk, chunk_control,
                       admission_lookahead) -> None:
        """The chunked-prefill arguments and their validation (reference
        :175-210). ``prefill_chunk`` is a power of 2 and a prefill bucket,
        so every non-final chunk is its own bucket (no padding) and the
        chunk shapes stay within the bucket set. ``chunk_control`` (a
        ``control.ChunkBudgetController``) scales the per-step prefill
        budget as a multiple of the chunk; None keeps at most one chunk
        a step."""
        self.prefill_chunk = None
        if prefill_chunk is not None:
            c = int(prefill_chunk)
            if c < 1 or (c & (c - 1)):
                raise ValueError(
                    f"prefill_chunk must be a power of 2, got "
                    f"{prefill_chunk}")
            if bucket_for(c, self.min_bucket, self.max_len) != c:
                raise ValueError(
                    f"prefill_chunk {c} must be a prefill bucket "
                    f"(>= the min_bucket floor and <= max_len "
                    f"{self.max_len})")
            self.prefill_chunk = c
        if chunk_control is not None and self.prefill_chunk is None:
            raise ValueError(
                "chunk_control requires prefill_chunk (the controller "
                "scales the chunked-prefill budget)")
        self.chunk_control = chunk_control
        if admission_lookahead < 0:
            raise ValueError(
                f"admission_lookahead must be >= 0, got "
                f"{admission_lookahead}")
        self.admission_lookahead = int(admission_lookahead)
        # PREFILLING slots in admission order: the head advances one
        # chunk a step (audited empty at quiesce)
        self._chunk_fifo: List[int] = []

    def _init_tier(self, kv_host_tier, host_tier_pages,
                   prefix_store_dir) -> None:
        """The KV host tier and its validation (reference :238-260,
        :366-387): cold refcount-0 prefix pages are demoted to host RAM
        (page-locked on the card) instead of destroyed, and promoted back
        on a radix hit; ``prefix_store_dir`` adds the persistent store
        under the RAM tier (and turns the tier on), ``host_tier_pages``
        bounds the RAM tier (None: unbounded). The tier OUTLIVES the
        cache: ``recover()``'s fresh cache rebuilds its host nodes from
        it."""
        self.kv_host_tier = bool(kv_host_tier) \
            or prefix_store_dir is not None
        self.prefix_store_dir = prefix_store_dir
        if host_tier_pages is not None and not self.kv_host_tier:
            raise ValueError(
                "host_tier_pages requires kv_host_tier=True (or "
                "prefix_store_dir=)")
        self._kv_tier = None
        # rid -> slot of requests whose host pages are being installed
        # on fresh device pages and not yet committed (audited empty at
        # quiesce)
        self._staged_promotions = {}
        if not self.kv_host_tier:
            return
        if not (self.paged and self.prefix_sharing):
            raise ValueError(
                "kv_host_tier requires the paged kv_layout with "
                "prefix_sharing enabled (the tier is keyed by radix "
                "chunks)")
        ad = self.adapter
        store = None
        if prefix_store_dir is not None:
            store = PersistentPrefixStore(
                prefix_store_dir, num_layers=ad.num_layers,
                page_size=self.page_size, kv_heads=ad.kv_heads,
                head_dim=ad.head_dim, dtype=ad.dtype, quant=self.kv_quant)
        self._kv_tier = HostPageTier(
            ad.num_layers, self.page_size, ad.kv_heads, ad.head_dim,
            ad.dtype, quant=self.kv_quant, capacity_pages=host_tier_pages,
            store=store, pin_payloads=ad.device.type == "cuda")

    def _init_families(self) -> None:
        """The engine's ``ptpu_serving_*`` and ``ptpu_kv_*`` registry
        families (reference :454-560)."""
        reg = self.registry
        self._m_queue_depth = reg.gauge(
            "ptpu_serving_queue_depth", "requests waiting for a slot")
        self._m_active = reg.gauge(
            "ptpu_serving_active_slots", "slots decoding this step")
        self._m_step = reg.histogram(
            "ptpu_serving_step_seconds",
            "wall time of one engine iteration (engine clock)")
        self._m_prefill = reg.counter(
            "ptpu_serving_prefills_total", "prefill program runs",
            labels=("bucket",))
        self._m_evict = reg.counter(
            "ptpu_serving_evictions_total", "slots freed",
            labels=("reason",))
        self._m_reject = reg.counter(
            "ptpu_serving_rejected_total",
            "submissions refused at admission", labels=("reason",))
        self._m_deadline = reg.counter(
            "ptpu_serving_deadline_cancellations_total",
            "requests cancelled at their deadline (queued + in-flight)")
        self._m_disconnect = reg.counter(
            "ptpu_serving_disconnects_total",
            "requests cancelled because their client went away")
        self._m_recover = reg.counter(
            "ptpu_serving_recoveries_total",
            "successful recover() calls after a broken step")
        self._m_replay_mismatch = reg.counter(
            "ptpu_serving_recover_replay_mismatch_total",
            "recovery re-prefills whose greedy replay token diverged "
            "from the already-delivered token")
        if self.prefill_chunk is not None:
            self._m_chunk_steps = reg.counter(
                "ptpu_serving_chunk_steps_total",
                "chunked-prefill chunk program runs")
            self._m_chunk_depth = reg.gauge(
                "ptpu_serving_chunk_queue_depth",
                "PREFILLING requests mid-chunked-prefill")
        if self.paged:
            self._m_pages_free = reg.gauge(
                "ptpu_serving_pages_free", "KV pages on the free list")
            self._m_pages_active = reg.gauge(
                "ptpu_serving_pages_active",
                "KV pages referenced by at least one request")
            self._m_pages_cached = reg.gauge(
                "ptpu_serving_pages_cached",
                "refcount-0 prefix-index pages (reclaimable)")
            self._m_kv_bytes = reg.gauge(
                "ptpu_serving_kv_bytes",
                "total device bytes of the paged KV pool (+scales)")
            self._m_kv_bytes.set(self.cache.kv_bytes())
            self._m_prefix_hit = reg.counter(
                "ptpu_serving_prefix_hit_tokens_total",
                "prompt tokens served from shared prefix pages")
            self._m_prefix_lookup = reg.counter(
                "ptpu_serving_prefix_lookup_tokens_total",
                "prompt tokens eligible for prefix matching")
            self._m_cow = reg.counter(
                "ptpu_serving_cow_copies_total",
                "copy-on-write page copies")
            self._last_page_stats = {"prefix_hit_tokens": 0,
                                     "prefix_lookup_tokens": 0,
                                     "cow_copies": 0}
        if self._kv_tier is not None:
            self._m_host_pages = reg.gauge(
                "ptpu_kv_host_pages",
                "KV pages resident in the host RAM tier")
            self._m_demotions = reg.counter(
                "ptpu_kv_demotions_total",
                "cold KV pages demoted device -> host tier")
            self._m_promotions = reg.counter(
                "ptpu_kv_promotions_total",
                "tiered KV pages promoted back onto device pages")
            self._m_tier_hit = reg.counter(
                "ptpu_kv_tier_prefix_hit_tokens_total",
                "prompt tokens served from demoted prefix pages, by "
                "the tier that held them", labels=("tier",))
            self._last_page_stats.update(
                demotions=0, promotions=0,
                prefix_hit_tokens_host=0, prefix_hit_tokens_disk=0)
        if self.speculative:
            self._m_spec_acc = reg.histogram(
                "ptpu_serving_spec_accepted_length",
                "tokens emitted per row per verify step (1 = k=1 "
                "fallback or fully rejected draft), by the proposer "
                "that drafted the row ('none' = undrafted)",
                buckets=tuple(float(i) for i in
                              range(1, self.spec_k + 1)),
                labels=("proposer",))
            self._m_spec_draft = reg.counter(
                "ptpu_serving_spec_draft_tokens_total",
                "draft tokens proposed to the verify program")
            self._m_spec_accepted = reg.counter(
                "ptpu_serving_spec_accepted_draft_tokens_total",
                "draft tokens confirmed by the verify program")
            self._m_spec_hit = reg.gauge(
                "ptpu_serving_spec_draft_hit_rate",
                "cumulative accepted/proposed draft-token ratio")
            self._m_spec_proposer = reg.counter(
                "ptpu_spec_proposer_total",
                "rows drafted per verify step, by proposer kind",
                labels=("kind",))
            if self._tuner is not None:
                self._m_spec_tuner_k = reg.gauge(
                    "ptpu_spec_tuner_k",
                    "spec window k the autotuner is running per "
                    "request class (1 = speculation off)",
                    labels=("klass",))

    def _new_cache(self, pools=None):
        """A KV cache in the configured layout with fresh host state;
        ``pools`` takes the device pools of an existing one over
        (``recover()``) instead of allocating new ones."""
        ad = self.adapter
        if self.paged:
            return PagedKVCache(
                ad.num_layers, self.max_slots, self.max_len, ad.kv_heads,
                ad.head_dim, ad.dtype, ad.device, page_size=self.page_size,
                num_pages=self.num_pages, quant=self.kv_quant,
                prefix_sharing=self.prefix_sharing, pools=pools,
                tier=self._kv_tier)
        return SlotKVCache(ad.num_layers, self.max_slots, self.max_len,
                           ad.kv_heads, ad.head_dim, ad.dtype, ad.device,
                           pools=pools)

    def _publish_page_stats(self) -> None:
        if not self.paged:
            return
        c = self.cache
        self._m_pages_free.set(c.free_page_count())
        self._m_pages_active.set(c.active_page_count())
        self._m_pages_cached.set(c.cached_page_count())
        last = self._last_page_stats
        for counter, key in ((self._m_prefix_hit, "prefix_hit_tokens"),
                             (self._m_prefix_lookup,
                              "prefix_lookup_tokens"),
                             (self._m_cow, "cow_copies")):
            cur = getattr(c, key)
            if cur > last[key]:
                counter.inc(cur - last[key])
            last[key] = cur
        if self._kv_tier is not None:
            self._m_host_pages.set(self._kv_tier.host_page_count())
            for counter, key in (
                    (self._m_demotions, "demotions"),
                    (self._m_promotions, "promotions"),
                    (self._m_tier_hit.labels(tier="host"),
                     "prefix_hit_tokens_host"),
                    (self._m_tier_hit.labels(tier="disk"),
                     "prefix_hit_tokens_disk")):
                cur = getattr(c, key)
                if cur > last[key]:
                    counter.inc(cur - last[key])
                last[key] = cur

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
        :class:`EngineBroken` until ``recover()``, :class:`QueueFull`
        when ``max_queue`` requests are already waiting."""
        self._check_admission()
        return self.submit_request(self._build_request(
            prompt_ids, max_new_tokens, sampling, deadline_s))

    def submit_request(self, req: Request) -> Request:
        """Enqueue a pre-built Request (the typed admission checks
        apply)."""
        self._check_admission()
        # sampled BEFORE the request enters the queue: a request that
        # arrives while other work is in flight may see its first token
        # wait behind prefills (the decode-stall histogram's population)
        stalled = self.has_work()
        self.scheduler.add(req)
        self.metrics.on_submit(req.rid, stalled=stalled)
        self._m_queue_depth.set(self.scheduler.depth)
        if self.auditor is not None:
            self.auditor.on_submitted(req)
        return req

    def adopt(self, req: Request) -> Request:
        """Take over an existing request mid-flight (its previous engine
        died). It may already carry delivered tokens: its admission then
        runs its prompt's prefill and writes those tokens by decode
        forwards (``_resume``, as ``recover()`` does), so greedy output
        goes on with the same tokens and nothing is retracted. Bypasses ``max_queue`` (a request the
        service already accepted is never dropped) and is not audited
        as a submission again (it was where it first entered)."""
        if self._closed:
            raise EngineClosed()
        if self._broken:
            raise EngineBroken(self._broken)
        req.slot = None
        req.prefill_pos = None
        stalled = self.has_work()
        self.scheduler.add(req)
        self.metrics.on_submit(req.rid, stalled=stalled)
        self._m_queue_depth.set(self.scheduler.depth)
        return req

    def has_work(self) -> bool:
        return self.scheduler.has_pending() or \
            bool(self.cache.active_slots())

    def probe(self, timeout: Optional[float] = None) -> dict:
        """Health probe: a cheap, non-mutating liveness summary. A
        broken engine is still alive (it answers and recovers), so this
        never raises."""
        del timeout  # in-process: answering at all is the liveness
        return {"broken": self._broken,
                "queued": self.scheduler.depth,
                "active": len(self.cache.active_slots())}

    def step(self) -> List[Request]:
        """One engine iteration: admit into free slots (bucketed or
        chunked prefill), advance the chunked prefill, one decode step
        over every decoding slot, evict finished sequences. Returns the
        requests finished this step (and any a failed step left
        undelivered).

        Every step appends a flight-recorder record; a step that raises
        marks the engine broken and dumps the recorder's ring before the
        exception propagates.

        Typed refusals: :class:`EngineBroken` until ``recover()`` after
        a failed step; :class:`EngineIdle` when there is no queued or
        in-flight work (guard loops with ``has_work()``)."""
        if self._broken:
            raise EngineBroken(self._broken)
        if not self.has_work():
            raise EngineIdle()
        t0 = self.metrics.now()
        step_idx = self._step_idx
        self._step_idx += 1
        # allocated outside the try: a request that reaches a terminal
        # state early in the step is already out of its slot or the
        # queue, so if the step then fails it must survive the raise
        finished: List[Request] = []
        try:
            with span("serving.step", step=step_idx) as sp, \
                    torch.inference_mode():
                admitted, n_active = self._step_inner(finished)
                sp.set_attr("active_slots", n_active)
        except Exception as e:
            if finished:
                self._undelivered.extend(finished)
            # the step may have written part of the pools in place:
            # refuse further use until recover() rebuilds the KV state
            self._broken = f"step #{step_idx}: {type(e).__name__}: {e}"
            try:
                self.recorder.record(
                    "serving.step_error", step=step_idx,
                    error=f"{type(e).__name__}: {e}")
                path = self.recorder.dump(
                    reason=f"ServingEngine.step #{step_idx} raised "
                           f"{type(e).__name__}: {e}",
                    registry=self.registry)
                print(f"[serving] flight recorder dumped to {path}",
                      file=sys.stderr)
            except Exception:
                pass               # never mask the original failure
            raise
        dt = self.metrics.now() - t0
        depth = self.scheduler.depth
        self._m_step.observe(dt)
        self._m_queue_depth.set(depth)
        self._m_active.set(n_active)
        wt = self._watchtower
        if wt is not None:
            wt.observe_step()
        if self._undelivered:
            # requests stranded by an earlier FAILED step ride the first
            # successful step out (they finished first: prepend)
            finished = self._undelivered + finished
        # the whole batch stays owed until the return below: if the
        # recorder or the auditor raises first, the next step(),
        # recover() or drain() still delivers it
        self._undelivered = finished
        self.recorder.record(
            "serving.step", step=step_idx, step_latency_s=dt,
            active_slots=n_active, queue_depth=depth,
            admitted=admitted,
            evicted=[(r.rid, r.finish_reason) for r in finished])
        if self.auditor is not None and not self._in_drain:
            # drain() audits its aggregate return instead, so each
            # request is audited at exactly ONE external boundary
            for r in finished:
                self.auditor.on_delivered(r, via="step")
        self._undelivered = []
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
        out first, or the engine is (or becomes) broken and the caller
        chose shutdown over ``recover()``, what remains is cancelled
        (``finish_reason == "cancelled"``, a :class:`RequestCancelled`
        naming the cause in ``Request.error``, chained to the failed
        step's exception) instead of being stranded. Never raises out of
        the step loop. Returns every request finished or cancelled
        during the drain, and any a failed step left undelivered.

        Unlike the reference, which retries a failed step up to three
        times on its undonated path, every failed step here breaks the
        engine, so the next pass cancels the rest."""
        self._closed = True
        done: List[Request] = []
        steps = 0
        last_err: Optional[BaseException] = None
        self._in_drain = True
        try:
            while self.has_work():
                if max_steps is not None and steps >= max_steps:
                    cutoff = "drain cutoff"
                elif self._broken:
                    cutoff = f"drain on broken engine ({self._broken})"
                else:
                    try:
                        done.extend(self.step())
                    except Exception as e:   # broken now: the next
                        last_err = e         # pass cancels the rest
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
        finally:
            self._in_drain = False
        if self._undelivered:
            # terminal requests a failed step stranded, with no
            # successful step left to carry them out
            done.extend(self._undelivered)
        self._proposer_retain(())          # a drained engine holds none
        # owed until the return happens: if the auditor raises, a
        # re-issued drain() hands the batch over
        self._undelivered = done
        if self.auditor is not None:
            for r in done:
                self.auditor.on_delivered(r, via="drain")
        self._undelivered = []
        return done

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Cancel one request (queued, PREFILLING or decoding; its pages
        return to the pool); False if it already finished. Delivered
        tokens stay on the handle."""
        if req.finished:
            return False
        if self.scheduler.remove(req):
            pass
        elif req.slot is not None and self.cache.slots[req.slot] is req:
            self._clear_chunk_state(req.slot, req)
            self.cache.release(req.slot)
            req.slot = None
            self._m_evict.labels(reason=reason).inc()
        else:
            return False
        req.finished, req.finish_reason = True, reason
        req.error = RequestCancelled(req.rid, reason)
        self.metrics.on_finished(req.rid)
        self._proposer_release(req.rid)
        if self.auditor is not None:
            self.auditor.on_delivered(req, via="cancel")
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

    def recover(self) -> dict:
        """Rebuild the KV state from host-side request state after a
        failed step (reference :1600-1726).

        The device pools are kept (nothing in them is read before it is
        written again) and the host state is fresh: the slot table and,
        paged, the free list, refcounts, page table and prefix index.
        Each in-flight request's KV is then written again the way its
        run wrote it, in admission order: its prompt by the route of its
        admission (the monolithic prefill at the prompt's bucket, or the
        same chunks; paged, after a shared prefix no longer than the one
        its admission matched, whose pages the requests admitted before
        it have written again by then), then its delivered tokens but
        the last through ``[max_slots, 1]`` decode forwards
        (``_resume``), so on the card the pools hold the failed run's
        bits and the tokens go on as an uninjected run's. (The reference
        re-prefills prompt + delivered tokens in one program; here that
        program would run the flash prefill over tokens whose KV the
        einsum decode wrote, and split greedy tokens at near-ties.) Two
        cases leave the failed run's route, and on the card may split
        greedy tokens at near-ties: a shared prefix whose pages came
        from a request that has finished since (the rebuilt index does
        not hold them, so the prompt runs from a shorter match; counted
        in the report's ``reroutes``), and a speculative engine's
        tokens, which verify blocks wrote.

        Latency: the re-prefills, plus one decode forward for each
        delivered token of the longest in-flight request (the rows
        replay together), so it grows linearly with how far that
        request got. A request that was PREFILLING re-enters the chunk
        FIFO at its start. For a greedy request the logits that
        predicted its last delivered token predict it again: checked,
        and counted in ``ptpu_serving_recover_replay_mismatch_total``
        (delivered tokens are never retracted). Safe to call again: a
        failure during recovery leaves the engine broken and the next
        ``recover()`` starts over from the same host state.

        With a host tier, the dying index's device pages are parked in
        the tier first (``PagedKVCache.park_in_tier``), which the
        reference does not do: one blocking D2H copy into page-locked
        memory for each indexed page the tier does not hold yet (the
        pages of prompts that were never demoted, or were promoted
        since), each written through to the prefix store when there is
        one. So the recover pays those copies and file writes on top of
        the re-prefills, and a store may afterwards hold pages that no
        demotion put there: a later engine over the same directory
        starts warmer than the reference's would.

        Covers failures raised on the host (fault points, a Python
        error mid-step); a CUDA error that poisons the context cannot be
        recovered in-process.

        Returns a report: the reason, recovered slot count, replay
        mismatches, reroutes, the requests handed back (finished in the
        failed step, or found finished or disconnected here), latency."""
        t0 = self.metrics.now()
        reason = self._broken
        in_flight = sorted(((s, r) for s, r in enumerate(self.cache.slots)
                            if r is not None),
                           key=lambda sr: sr[1]._admit_seq)
        # PREFILLING requests go back into the FIFO, in its order (they
        # were admitted after every decoding request: while the FIFO is
        # not empty every admission chunks)
        prefilling = [s for s in self._chunk_fifo]
        self._chunk_fifo.clear()
        for _, r in in_flight:
            r.prefill_pos = None
        old = self.cache
        pools = (old.ks, old.vs, old.kss, old.vss) if self.paged \
            else (old.ks, old.vs)
        # staged promotions die with the old host state; the tier itself
        # SURVIVES: the old index's device pages are parked in it too,
        # and the fresh cache rebuilds host nodes for all of it, so a
        # request that matched a shared prefix (on the device or through
        # a promotion) matches it again and writes its prompt by the same
        # promotion and extend, even if the prefix's writer has finished
        self._staged_promotions.clear()
        if self._kv_tier is not None:
            old.park_in_tier()
        if self.paged:
            # flush the old cache's counter deltas, then re-baseline:
            # the fresh cache restarts its counters at zero
            self._publish_page_stats()
            self._last_page_stats = {k: 0
                                     for k in self._last_page_stats}
        self.cache = self._new_cache(pools=pools)
        del old, pools
        # accumulate on the ENGINE, not a local: if a re-prefill below
        # fails, these requests are gone from the slot table and the
        # retried recover() must still hand them back
        finished = self._undelivered
        todo = []
        for s, req in in_flight:
            if req.finished:
                # completed inside the failed step, never delivered
                req.slot = None
                self._m_evict.labels(
                    reason=req.finish_reason or "unknown").inc()
                self.metrics.on_finished(req.rid)
                finished.append(req)
            else:
                # bookkeeping FIRST, so a failure mid-re-prefill leaves
                # the slot table complete for the next recover()
                self.cache.assign(s, req)
                todo.append((s, req))
        reroutes = 0
        resume = []
        with torch.inference_mode():
            for s, req in todo:
                if self._cancel_requested(req):
                    # the client went away while the engine was down
                    self.cache.release(s)
                    req.slot = None
                    self._finish_disconnect(
                        req, "client disconnected during recover()",
                        finished=finished)
                    continue
                if s in prefilling:
                    continue
                shared = req._shared_len
                logits = self._reprefill_prompt(s, req)
                reroutes += req._shared_len != shared
                if req.out_tokens:
                    resume.append((s, req, logits))
                    continue
                # the failed step died between the slot assignment and
                # the first sampled token: finish the admission
                tok = sample_token(logits, req.sampling, req._rng)
                req.out_tokens.append(tok)
                self.metrics.on_token(req.rid)
                if self._is_finished(req, tok):
                    self._evict(s, req, finished)
            mismatches = self._resume(resume)
            for s in prefilling:
                req = self.cache.slots[s]
                if req is not None:
                    shared = req._shared_len
                    self._enter_prefilling(s, req, share_limit=shared)
                    reroutes += req._shared_len != shared
        # draft state only for the requests that survived into the
        # rebuilt slot table, in every configured proposer
        self._proposer_retain(
            r.rid for r in self.cache.slots if r is not None)
        self._broken = None
        self._m_recover.inc()
        dt = self.metrics.now() - t0
        report = {"reason": reason,
                  "recovered_slots": len(todo),
                  "replay_mismatches": mismatches,
                  "reroutes": reroutes,
                  "finished": list(finished),
                  "latency_s": dt}
        self.recorder.record(
            "serving.recover", reason=reason, latency_s=dt,
            recovered_slots=len(todo), replay_mismatches=mismatches,
            reroutes=reroutes,
            evicted=[(r.rid, r.finish_reason) for r in finished])
        if self.auditor is not None:
            for r in report["finished"]:
                self.auditor.on_delivered(r, via="recover")
        # consumed only once the report is on its way to the caller
        self._undelivered = []
        return report

    def _reprefill_prompt(self, slot: int, req: Request) -> np.ndarray:
        """``recover()``: write the prompt's KV by the route of the
        request's admission (its bits on the card) and return the logits
        at its last token: the monolithic prefill, or, for a request
        admitted through the chunk FIFO, the same chunks in a row; paged,
        after a shared prefix no longer than its admission's."""
        if not req._chunked:
            return self._prefill_raw(slot, req.prompt, req,
                                     share_limit=req._shared_len)
        start = self._claim_for_chunks(slot, req,
                                       share_limit=req._shared_len)
        n, chunk = req.prompt_len, self.prefill_chunk
        for pos in range(start, n, chunk):
            t = min(chunk, n - pos)
            logits = self._run_chunk(
                slot, self._padded(req.prompt, pos,
                                   bucket_for(t, self.min_bucket,
                                              self.max_len)), pos, t)
        if self.paged:
            self.cache.register_prefix(slot, req.prompt)
        return logits

    def _resume(self, rows) -> int:
        """Bring requests that already carry delivered tokens, their
        prompts just written, back to where they stopped: ``rows`` are
        (slot, request, the logits at its prompt's last token), from
        ``recover()`` or from an admission (``adopt()``, a requeue after
        a failed admission). A request with one token checks it against
        those logits; the rest write their tokens through
        ``_replay_decode``, together. Returns the mismatches."""
        mismatches, replay = 0, []
        for s, req, logits in rows:
            if len(req.out_tokens) > 1:
                replay.append((s, req))
            else:
                mismatches += self._check_replay(req, logits)
        return mismatches + self._replay_decode(replay)

    def _replay_decode(self, rows) -> int:
        """``recover()``: write the delivered tokens' KV (all but each
        request's last, whose KV the next decode step writes) the way
        the decode steps wrote it, by ``[max_slots, 1]`` decode forwards:
        forward ``j`` feeds each row its delivered token ``j`` at its
        position, rows done being inactive (they write nothing). A row's
        bits depend on its own tokens and KV alone, so they are the
        failed run's. The forward that feeds a row's second-to-last
        token predicts its last one again: checked. Returns the
        mismatches."""
        mismatches = 0
        steps = max((len(r.out_tokens) for _, r in rows), default=1) - 1
        for j in range(steps):
            active = [s for s, r in rows if len(r.out_tokens) - 1 > j]
            toks = np.zeros((self.max_slots, 1), np.int64)
            pos = np.zeros((self.max_slots,), np.int64)
            copies = []
            for s in active:
                req = self.cache.slots[s]
                toks[s, 0] = req.out_tokens[j]
                pos[s] = req.prompt_len + j
                if self.paged:
                    c = self.cache.ensure_decode_page(s, int(pos[s]))
                    if c is not None:
                        copies.append(c)
            if self.paged:
                self._run_copies(copies)
            logits = self._decode_logits(active, toks, pos, masked=True)
            for s in active:
                req = self.cache.slots[s]
                if j == len(req.out_tokens) - 2:
                    mismatches += self._check_replay(req, logits[s])
        return mismatches

    def inflight_rids(self) -> set:
        """Every request id the engine itself still owns: queued, in a
        slot (PREFILLING or decoding), staged mid-promotion, or finished
        but not yet delivered. Diffed against ``metrics.inflight_phases()``, a rid
        the metrics still track and the engine does not is a request
        some failure path dropped."""
        rids = {r.rid for r in self.scheduler.pending()}
        for s in self.cache.active_slots():
            rids.add(self.cache.slots[s].rid)
        rids.update(r.rid for r in self._undelivered)
        rids.update(self._staged_promotions)
        return rids

    # -- admission -----------------------------------------------------
    def _check_admission(self) -> None:
        if self._closed:
            raise EngineClosed()
        if self._broken:
            raise EngineBroken(self._broken)
        if self.max_queue is not None \
                and self.scheduler.depth >= self.max_queue:
            self._m_reject.labels(reason="queue_full").inc()
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
    def _step_inner(self, finished: List[Request]):
        admitted: List[int] = []
        # 0) deadline and disconnect sweeps, before any prefill or
        # decode is spent on those requests
        self._expire_deadlines(finished)
        self._sweep_disconnects(finished)
        # 1) admission: freed slots refill BEFORE the decode, so a new
        # request's first decode token rides this very step. Paged:
        # admission is gated by FREE PAGES as well as free slots: the
        # claim reserves the request's worst-case page span
        claim = unclaim = None
        if self.paged:
            def claim(req):
                return self.cache.try_reserve(
                    req, req.prompt, req.prompt_len + req.max_new_tokens)
            unclaim = self.cache.cancel_reservation
        pairs = self.scheduler.admissions(
            self.cache.free_slots(), claim=claim,
            lookahead=self.admission_lookahead, unclaim=unclaim)
        # the per-step prefill token budget of a chunked engine: one
        # chunk's worth. A prompt that fits runs the monolithic prefill
        # inside the budget; a longer one claims its slot and pages now
        # and enters the PREFILLING FIFO, advancing one chunk a step
        # below, so no step runs more than `prefill_chunk` prefill
        # tokens beside the decode
        chunk = self.prefill_chunk
        budget = chunk
        if chunk is not None and self.chunk_control is not None:
            # queued and chunk-pending work push the budget up, the
            # decoding population (which every extra chunk stalls)
            # pulls it down
            budget = self.chunk_control.step_budget(
                chunk,
                self.scheduler.depth + len(self._chunk_fifo),
                stall=float(len(self.cache.active_slots())))
        for i, (slot, req) in enumerate(pairs):
            try:
                if chunk is None:
                    self._prefill(slot, req)
                else:
                    if not self._chunk_fifo and req.prompt_len <= budget:
                        self._prefill(slot, req)
                        budget -= req.prompt_len
                    else:
                        self._begin_chunked(slot, req)
            except RequestCancelled as e:
                # the client vanished while THIS request was being
                # prefilled: the abort path already returned its pages
                # and no slot was assigned; cancel it alone and go on
                self._finish_disconnect(req, exc=e, finished=finished)
                continue
            except Exception:
                # admissions() popped the whole batch: what was not
                # admitted goes back to the queue head in FCFS order,
                # its page reservation returned (a request adopted with
                # tokens too, unlike the reference, which drops it)
                for _, later in reversed(pairs[i + 1:]):
                    if self.paged:
                        self.cache.cancel_reservation(later)
                    self.scheduler.requeue(later)
                if req.slot is None:
                    if self.paged:
                        self.cache.cancel_reservation(req)
                    self.scheduler.requeue(req)
                raise
            admitted.append(req.rid)
            if req.finished:
                self._evict(slot, req, finished)
        # 1b) PREFILLING work within what is left of the budget: at most
        # one chunk a step without a chunk controller; with one, chunks
        # run back to back until its budget is spent
        ran = 0
        while chunk is not None and self._chunk_fifo:
            head = self.cache.slots[self._chunk_fifo[0]]
            take = min(chunk, head.prompt_len - head.prefill_pos)
            if take > budget:
                break
            self._chunk_step(finished)
            budget -= take
            ran += 1
            if self.chunk_control is None and ran >= 1:
                break
        if chunk is not None:
            self._m_chunk_depth.set(len(self._chunk_fifo))
        # 2) one decode step over the decoding slots (the speculative
        # engine runs its k-wide verify instead); PREFILLING slots hold
        # no decodable token until their final chunk
        active = [s for s in self.cache.active_slots()
                  if self.cache.slots[s].prefill_pos is None]
        if active:
            if self.speculative:
                self._decode_verify(active, finished)
            else:
                self._decode(active, finished)
        self.metrics.on_step(len(active))
        if self.paged:
            self.peak_active_slots = max(self.peak_active_slots,
                                         len(active))
            self._publish_page_stats()
        return admitted, len(active)

    def _check_replay(self, req: Request, logits: np.ndarray) -> int:
        """A replay's re-predicted token against the delivered one
        (greedy requests only); 1 and the mismatch counter bumped when
        they differ."""
        if req.sampling.temperature <= 0 \
                and int(np.argmax(logits)) != req.out_tokens[-1]:
            self._m_replay_mismatch.inc()
            return 1
        return 0

    def _admit(self, req: Request, chunked: bool) -> None:
        """Record the route of an admission, which ``recover()`` takes
        again: chunked or not, and its place in the admission order."""
        req._chunked = chunked
        req._admit_seq = self._admissions
        self._admissions += 1

    def _prefill(self, slot: int, req: Request) -> None:
        """Run the request's bucketed prefill into its slot and sample
        its first token (TTFT). A request that already carries tokens
        (adopted, or requeued after a fault) writes them after its
        prompt instead (``_resume``)."""
        self.metrics.on_first_prefill(req.rid)   # queue wait ends here
        self._admit(req, chunked=False)
        logits = self._prefill_raw(slot, req.prompt, req, cancel_check=True)
        self.cache.assign(slot, req)
        req.slot = slot
        if req.out_tokens:
            self._resume([(slot, req, logits)])
            return
        tok = sample_token(logits, req.sampling, req._rng)
        req.out_tokens.append(tok)
        self.metrics.on_token(req.rid)
        self._is_finished(req, tok)

    def _prefill_raw(self, slot: int, ids: np.ndarray, req: Request,
                     cancel_check: bool = False,
                     share_limit: Optional[int] = None) -> np.ndarray:
        """Write ``ids``'s k/v into positions ``0..len-1`` of the slot
        and return the host logits at the last real token; shared by the
        admission prefill and ``recover()``'s re-prefill.

        Paged (reference ``_prefill_raw``'s paged branch): reserve if
        the request holds no reservation yet (``recover()``), match it
        again (at most ``share_limit`` tokens), consume it into the
        slot's page table (the match's length kept as the request's
        ``_shared_len``), run the COW copies, then the full prefill
        (nothing matched) or the extend over the shared pages, and index
        the prompt's full pages. Any failure after the reservation
        returns every page (``abort_sequence``). ``cancel_check``: a
        client found gone raises :class:`RequestCancelled` before the
        model runs."""
        maybe_fail("serving.step.prefill", slot=slot)
        n = int(ids.shape[0])
        if not self.paged:
            if cancel_check and self._cancel_requested(req):
                raise RequestCancelled(
                    req.rid, "client disconnected before prefill")
            bucket = bucket_for(n, self.min_bucket, self.max_len)
            self._m_prefill.labels(bucket=bucket).inc()
            with span("serving.prefill", request_id=req.rid, slot=slot,
                      bucket=bucket, prompt_len=n,
                      replay=bool(req.out_tokens)):
                return self._full_prefill(slot, self._padded(ids, 0, bucket),
                                          n)
        cache = self.cache
        try:
            if req.rid not in cache._plans and not cache.try_reserve(
                    req, ids, req.prompt_len + req.max_new_tokens,
                    share_limit):
                raise RuntimeError(
                    f"request {req.rid}: page reservation failed on "
                    f"re-prefill (pool too small for the in-flight set)")
            # same-wave sharing: earlier admissions of this batch have
            # registered their pages since the claim
            cache.refresh_reservation(req, ids, share_limit)
            start, copies = cache.begin_sequence(slot, req, ids)
            req._shared_len = start
            # pages claimed, the table row live, nothing run yet: the
            # abort path below must return every page
            maybe_fail("serving.prefill.paged", slot=slot,
                       shared=start > 0)
            if cancel_check and self._cancel_requested(req):
                raise RequestCancelled(
                    req.rid, "client disconnected mid-prefill")
            self._run_copies(copies)
            # promoted host pages install BEFORE the extend attends over
            # them (staged; unwound on a failure)
            self._stage_promotions(req, slot)
            tail = n - start
            bucket = bucket_for(tail, self.min_bucket, self.max_len)
            self._m_prefill.labels(bucket=bucket).inc()
            with span("serving.prefill", request_id=req.rid, slot=slot,
                      bucket=bucket, prompt_len=n, shared_prefix=start,
                      replay=bool(req.out_tokens)):
                padded = self._padded(ids, start, bucket)
                if start == 0:
                    logits = self._full_prefill(slot, padded, n)
                else:
                    logits = self._extend(padded, start, tail,
                                          cache.page_table[slot][None].copy())
            cache.register_prefix(slot, ids)
            return logits
        except Exception:
            # the staged promotion (if any) goes with the page claims
            self._staged_promotions.pop(req.rid, None)
            cache.abort_sequence(slot, req)
            raise

    def _padded(self, ids: np.ndarray, start: int, bucket: int):
        """``ids[start:start + bucket]`` zero-padded to ``[1, bucket]``
        on the device."""
        padded = np.zeros((1, bucket), np.int64)
        tail = ids[start:start + bucket]
        padded[0, :len(tail)] = tail
        return torch.from_numpy(padded).to(self.adapter.device)

    def _logits(self, ids, n: int, caches):
        """One model call over ``ids`` [1, bucket] with ``caches``: the
        host logits at token ``n - 1`` and the new caches."""
        ad = self.adapter
        h, new_caches = ad.call(ids, caches)
        logits = ad.head(h[:, n - 1:n])[0, -1]
        return logits.float().cpu().numpy(), new_caches

    def _full_prefill(self, slot: int, padded, n: int) -> np.ndarray:
        """The monolithic prefill of ``n`` tokens at position 0, the
        route that runs the flash-attention kernel: on the slot's row of
        the contiguous pool (positions ``0..bucket-1``; the padded tail
        is garbage the causal mask hides and each decode step
        overwrites before attending), or through a local cache written
        into the slot's pages (``_paginated_prefill``)."""
        bucket = padded.shape[1]
        if not self.paged:
            # views of the slot's rows: the prefill writes the pool in
            # place
            caches = [(k[slot:slot + 1, :bucket], v[slot:slot + 1, :bucket],
                       0) for k, v in zip(self.cache.ks, self.cache.vs)]
            return self._logits(padded, n, caches)[0]
        npg = -(-bucket // self.cache.page_size)
        return self._paginated_prefill(
            padded, n, self.cache.page_table[slot][:npg].copy())

    # -- chunked prefill -------------------------------------------------
    def _begin_chunked(self, slot: int, req: Request) -> None:
        """Claim a slot for a CHUNKED prefill without running any model
        call: the request enters the PREFILLING state (slot leased,
        pages placed, ``prefill_pos`` at the shared-prefix boundary) and
        advances one chunk a step from the FIFO head (``_chunk_step``).
        The paged admission already reserved the worst-case page span,
        so chunking never runs out of pages mid-prompt."""
        self.metrics.on_first_prefill(req.rid)   # queue wait ends here
        self._admit(req, chunked=True)
        self._enter_prefilling(slot, req)
        self.cache.assign(slot, req)
        req.slot = slot

    def _enter_prefilling(self, slot: int, req: Request,
                          share_limit: Optional[int] = None) -> None:
        """Place the request's pages (paged) and put its slot at the
        chunk FIFO's tail, PREFILLING from the shared-prefix boundary."""
        start = self._claim_for_chunks(slot, req, share_limit)
        req.prefill_pos = int(start)
        self._chunk_fifo.append(slot)

    def _claim_for_chunks(self, slot: int, req: Request,
                          share_limit: Optional[int] = None) -> int:
        """Paged: reserve (if the request holds no reservation yet),
        match again (at most ``share_limit`` tokens) and consume the
        reservation into the slot's page table, COW copies run; any
        failure returns every page. Returns the shared-prefix length (0
        on the contiguous layout), kept as the request's
        ``_shared_len``."""
        if not self.paged:
            return 0
        cache, ids = self.cache, req.prompt
        try:
            if req.rid not in cache._plans and not cache.try_reserve(
                    req, ids, req.prompt_len + req.max_new_tokens,
                    share_limit):
                raise RuntimeError(
                    f"request {req.rid}: page reservation failed at "
                    f"chunked admission")
            cache.refresh_reservation(req, ids, share_limit)
            start, copies = cache.begin_sequence(slot, req, ids)
            req._shared_len = start
            self._run_copies(copies)
            self._stage_promotions(req, slot)
        except Exception:
            # the abort path returns every claim (the slot lease, if
            # held, is left alone); the caller requeues, or recover()
            # starts over
            self._staged_promotions.pop(req.rid, None)
            cache.abort_sequence(slot, req)
            raise
        return start

    def _chunk_step(self, finished: List[Request]) -> None:
        """Advance the PREFILLING FIFO head by one chunk: write tokens
        ``prefill_pos .. prefill_pos + t - 1`` into the slot's KV,
        attending over everything already written, and on the FINAL
        chunk sample the first token and enter decode."""
        slot = self._chunk_fifo[0]
        req = self.cache.slots[slot]
        ids, n = req.prompt, req.prompt_len
        pos = req.prefill_pos
        t = min(self.prefill_chunk, n - pos)
        final = pos + t >= n
        try:
            # slot leased, pages claimed, part of the prompt written:
            # the unwind below frees the pages AND the lease and
            # requeues
            maybe_fail("serving.prefill.chunk", slot=slot, pos=pos,
                       final=final)
            if self._cancel_requested(req):
                raise RequestCancelled(
                    req.rid, "client disconnected mid-chunked-prefill")
            bucket = bucket_for(t, self.min_bucket, self.max_len)
            self._m_prefill.labels(bucket=bucket).inc()
            with span("serving.chunk_prefill", request_id=req.rid,
                      slot=slot, pos=pos, chunk=t, final=final,
                      replay=bool(req.out_tokens)):
                logits = self._run_chunk(slot, self._padded(ids, pos,
                                                            bucket), pos, t)
        except RequestCancelled as e:
            self._unwind_chunk(slot, req, requeue=False)
            self._finish_disconnect(req, exc=e, finished=finished)
            return
        except Exception:
            self._unwind_chunk(slot, req, requeue=True)
            raise
        req.prefill_pos = pos + t
        self._m_chunk_steps.inc()
        if final:
            self._finish_chunked(slot, req, logits, finished)

    def _run_chunk(self, slot: int, padded, pos: int, t: int) -> np.ndarray:
        """One chunk (reference ``_chunk_fn``, run eagerly): the
        ``[1, bucket]`` chunk at scalar position ``pos``, its first
        ``t`` tokens real, through the einsum cache attention (never the
        flash kernel, as in the reference, whose cache has none), and
        the host logits at token ``t - 1`` (only the final chunk's are
        used). Contiguous: on the slot's ``[1, max_len]`` row of the
        pool, writes past ``t`` masked (``wlen``). Paged: the extend at
        a mid-prompt start through the slot's page table, writes past
        ``t`` sent to trash page 0."""
        if self.paged:
            return self._extend(padded, pos, t,
                                self.cache.page_table[slot][None].copy(),
                                wlen=t)
        wl = torch.tensor([t], device=self.adapter.device)
        caches = [(k[slot:slot + 1], v[slot:slot + 1], pos, wl)
                  for k, v in zip(self.cache.ks, self.cache.vs)]
        return self._logits(padded, t, caches)[0]

    def _finish_chunked(self, slot: int, req: Request, logits: np.ndarray,
                        finished: List[Request]) -> None:
        """Final chunk done: leave the PREFILLING state and enter
        decode (a request that carries tokens writes them instead,
        ``_resume``), as the tail of the monolithic ``_prefill`` does."""
        self._chunk_fifo.pop(0)
        req.prefill_pos = None
        if self.paged:
            self.cache.register_prefix(slot, req.prompt)
        if req.out_tokens:
            self._resume([(slot, req, logits)])
            return
        tok = sample_token(logits, req.sampling, req._rng)
        req.out_tokens.append(tok)
        self.metrics.on_token(req.rid)
        if self._is_finished(req, tok):
            self._evict(slot, req, finished)

    def _clear_chunk_state(self, slot: int, req: Request) -> None:
        """Drop a PREFILLING request's chunk bookkeeping without
        touching the cache (the terminal paths release the slot
        themselves)."""
        if req.prefill_pos is None:
            return
        req.prefill_pos = None
        if slot in self._chunk_fifo:
            self._chunk_fifo.remove(slot)

    def _unwind_chunk(self, slot: int, req: Request,
                      requeue: bool) -> None:
        """Unwind a PREFILLING slot after a mid-chunk fault or
        disconnect: the chunk bookkeeping goes, the paged claims return
        through the abort path and the lease frees (abort_sequence
        zeroed the table row and popped the plan, so release() has
        nothing left to unref). ``requeue`` puts the request back at
        the queue head; its replay re-chunks from the start."""
        self._clear_chunk_state(slot, req)
        if self.paged:
            self.cache.abort_sequence(slot, req)
        self.cache.release(slot)
        req.slot = None
        if requeue:
            self.scheduler.requeue(req)

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

    def _extend(self, padded, start: int, tail: int, table: np.ndarray,
                wlen: Optional[int] = None):
        """The paged extend: ``tail`` tokens run through the paged cache
        path at position ``start``, attending over the pages already
        written (shared prefix pages, earlier chunks) through the slot's
        table and writing their own k/v through it. Bucket padding past
        the table goes to the trash page, and with ``wlen`` every write
        past the first ``wlen`` tokens does (the chunk's padding)."""
        caches = self._paged_caches(table, start)
        if wlen is not None:
            wl = torch.tensor([wlen], device=self.adapter.device)
            caches = [c + (wl,) for c in caches]
        return self._logits(padded, tail, caches)[0]

    def _stage_promotions(self, req: Request, slot: int) -> None:
        """Install this request's planned tier promotions on their fresh
        device pages BEFORE the extend reads them (reference
        :2772-2820). Staged in ``_staged_promotions`` before the
        ``serving.kv.promote`` fault point; popped on a successful
        commit, or unwound HERE through ``abort_sequence`` on any raise
        (the caller's own abort is then a no-op: the plan is gone), so a
        failure returns the promotion's pages AND the tier pins. The
        wait (``ptpu_kv_promotion_wait_seconds``) runs to the install's
        completion: the tier fetch, the H2D copies and the pool
        writes."""
        c = self.cache
        plan = c._plans.get(req.rid)
        if plan is None or not plan["promote"]:
            return
        rid = req.rid
        self._staged_promotions[rid] = slot
        self.metrics.on_promotion_start(rid)
        t0 = self.metrics.now()
        try:
            maybe_fail("serving.kv.promote", slot=slot, rid=rid,
                       pages=len(plan["promote"]))
            with span("serving.kv_promote", slot=slot, request_id=rid,
                      pages=len(plan["promote"])):
                work = c.begin_promotions(req)
                self._install_pages(work)
                c.commit_promotions(req, work)
        except BaseException:
            self._staged_promotions.pop(rid, None)
            c.abort_sequence(slot, req)
            raise
        self._staged_promotions.pop(rid, None)
        self.metrics.on_promotion(rid, self.metrics.now() - t0)

    def _install_pages(self, work) -> None:
        """Write each promoted payload into its ``dst`` page of every
        layer's pool, in place: one H2D copy of the payload (from
        page-locked memory on the card; the caching host allocator keeps
        the buffer until the copy has run), then a slice write per layer.
        The reference's install is an XLA program, not a Pallas kernel.
        Returns once the writes have completed on the device."""
        c, dev = self.cache, self.adapter.device
        pools = (c.ks, c.vs, c.kss, c.vss)
        for _node, dst, payload, _label in work:
            for field, pool in zip(("k", "v", "ks", "vs"), pools):
                if not pool:
                    continue
                staged = payload[field].to(dev, non_blocking=True)
                for i, p in enumerate(pool):
                    p[dst].copy_(staged[i])
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

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
        # COW copies run BEFORE the fault point: ensure_decode_page
        # already flipped the table rows, so the device must match the
        # table whenever the fault can fire
        if self.paged:
            self._run_copies(copies)
        maybe_fail("serving.step.decode", step=self._step_idx - 1)
        with span("serving.decode", batch=len(active),
                  request_ids=[self.cache.slots[s].rid for s in active]):
            # chunked engines write-mask the inactive rows: the plain
            # call writes every row's k/v at position 0, which would
            # overwrite a PREFILLING slot's first chunk
            logits = self._decode_logits(
                active, toks, pos, masked=self.prefill_chunk is not None)
        for s in active:
            req = self.cache.slots[s]
            tok = sample_token(logits[s], req.sampling, req._rng)
            req.out_tokens.append(tok)
            self.metrics.on_token(req.rid)
            if self._is_finished(req, tok):
                self._evict(s, req, finished)

    def _decode_logits(self, active, toks: np.ndarray, pos: np.ndarray,
                       masked: bool) -> np.ndarray:
        """One ``[max_slots, 1]`` forward feeding ``toks`` at ``pos``:
        host logits [max_slots, vocab]. Inactive rows run at position 0,
        on the paged layout through trash page 0; ``masked`` (contiguous)
        gates the writes so that only active rows write (their writes
        and attention keep the bits of the plain call)."""
        ad = self.adapter
        pos_dev = torch.from_numpy(pos).to(ad.device)
        if self.paged:
            table = np.zeros_like(self.cache.page_table)
            table[active] = self.cache.page_table[active]
            caches = self._paged_caches(table, pos_dev)
        elif masked:
            act = np.zeros((self.max_slots,), np.int64)
            act[active] = 1
            wl = torch.from_numpy(act).to(ad.device)
            caches = [(k, v, pos_dev, wl)
                      for k, v in zip(self.cache.ks, self.cache.vs)]
        else:
            caches = [(k, v, pos_dev)
                      for k, v in zip(self.cache.ks, self.cache.vs)]
        h, _ = ad.call(torch.from_numpy(toks).to(ad.device), caches)
        return ad.head(h[:, -1:])[:, -1].float().cpu().numpy()

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
        contained to its row (``_on_draft_fault``).

        Fault points: ``serving.spec.draft`` (one row's proposal,
        contained), ``serving.decode.verify`` (drafts built, pages
        claimed, nothing emitted yet; also on a gated step) and
        ``serving.spec.resample`` (in ``_emit_verified``)."""
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
                    maybe_fail("serving.spec.draft",
                               step=self._step_idx - 1, slot=s)
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
                    self._m_spec_draft.inc(len(draft))
                    self._m_spec_proposer.labels(kind=kind).inc()
            wlen[s] = n
        if self.spec_gate and all(int(wlen[s]) == 1 for s in active):
            # no row drafted: the k=1 decode emits the same tokens (the
            # same logits row, the same per-request RNG stream) at 1/k
            # of the verify's work; no page state was touched yet. The
            # verify's fault point still guards every speculative step
            maybe_fail("serving.decode.verify", step=self._step_idx - 1,
                       gated=True)
            n_rows = len(active)
            self._decode(active, finished)
            # counted AFTER the delegated step succeeds: a fault inside
            # it replays through this gate after recover()
            self._spec["gated_steps"] += 1
            self._spec["rows"] += n_rows
            self._spec["emitted"] += n_rows
            self._spec["acc_len_hist"][1] += n_rows
            for _ in range(n_rows):
                self._m_spec_acc.labels(proposer="none").observe(1.0)
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
                # COW copies BEFORE the fault point (as in the decode)
                self._run_copies(copies)
            maybe_fail("serving.decode.verify", step=self._step_idx - 1)
            with span("serving.verify", batch=len(active), k=K,
                      request_ids=[self.cache.slots[s].rid
                                   for s in active]):
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
                self._m_spec_acc.labels(
                    proposer=row_kind.get(s, "none")).observe(
                        float(emitted))
                if emitted > 1:
                    self._m_spec_accepted.inc(emitted - 1)
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
        if self._spec["draft_tokens"]:
            self._m_spec_hit.set(self._spec["accepted_draft_tokens"]
                                 / self._spec["draft_tokens"])
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
                # (a failure here must neither lose nor duplicate tokens)
                maybe_fail("serving.spec.resample",
                           step=self._step_idx - 1, slot=slot)
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
        row falls back to k=1. An injected fault fires before the
        proposer runs, and the n-gram proposer's index is derived from
        confirmed history, so the rid is unwound; a draft model's own
        failure may have come part-way through its in-place pool writes,
        so that proposer is reset whole (its pools are allocated again).
        ``draft_faults`` counts it."""
        if isinstance(exc, InjectedFault) \
                or not isinstance(proposer, DraftModelProposer):
            proposer.unwind(req.rid)
        else:
            proposer.reset()
        self._spec["draft_faults"] += 1

    def _tuner_step(self, attempted: dict, accepted: dict) -> None:
        """Feed one step's accepted lengths to the tuner and advance its
        clock (no-op without ``spec_tune``)."""
        if self._tuner is None:
            return
        for s, (klass, kind) in attempted.items():
            self._tuner.observe(klass, kind, accepted.get(s, 1))
        self._tuner.on_step()
        for klass, st in self._tuner.snapshot()["classes"].items():
            self._m_spec_tuner_k.labels(klass=klass).set(st["k"])

    # -- bookkeeping ---------------------------------------------------
    def _is_finished(self, req: Request, tok: int) -> bool:
        if self.eos_id is not None and tok == self.eos_id:
            req.finished, req.finish_reason = True, "eos"
        elif len(req.out_tokens) >= req.max_new_tokens:
            req.finished, req.finish_reason = True, "length"
        return req.finished

    def _evict(self, slot: int, req: Request,
               finished: List[Request]) -> None:
        # a PREFILLING request can reach a terminal state mid-prefill
        # (deadline, disconnect, drain cutoff): drop its chunk
        # bookkeeping so release() is the whole cleanup
        self._clear_chunk_state(slot, req)
        self.cache.release(slot)
        req.slot = None
        finished.append(req)
        self._m_evict.labels(reason=req.finish_reason or "unknown").inc()
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
            self._m_deadline.inc()
            self.metrics.on_finished(req.rid)
            finished.append(req)
        for s in self.cache.active_slots():
            req = self.cache.slots[s]
            if req.deadline is not None and now > req.deadline:
                req.finished, req.finish_reason = True, "deadline"
                req.error = DeadlineExceeded(
                    req.rid, f"expired in slot {s} after "
                             f"{len(req.out_tokens)} token(s)")
                self._m_deadline.inc()
                self._evict(s, req, finished)

    def _cancel_requested(self, req: Request) -> bool:
        """True if the client behind ``req`` is known gone: the
        request's own flag, else the ``cancel_probe``. A probe that
        itself raises reads as 'still connected'."""
        if req.cancel_requested:
            return True
        probe = self.cancel_probe
        if probe is None:
            return False
        try:
            if probe(req):
                req.cancel_requested = True
                return True
        except Exception:
            return False
        return False

    def _finish_disconnect(self, req: Request,
                           detail: Optional[str] = None,
                           exc: Optional[BaseException] = None,
                           finished: Optional[List[Request]] = None) \
            -> None:
        """The terminal bookkeeping of every path that finds the client
        gone (prefill abort, the sweeps, recover). Callers that evict a
        slot pass ``finished=None`` and let ``_evict`` deliver."""
        req.finished, req.finish_reason = True, "disconnect"
        req.error = exc if exc is not None \
            else RequestCancelled(req.rid, detail or "disconnect")
        self._m_disconnect.inc()
        if finished is not None:
            self.metrics.on_finished(req.rid)
            finished.append(req)

    def _sweep_disconnects(self, finished: List[Request]) -> None:
        """Cancel queued and in-flight requests whose client went away
        (the deadline sweep's step-boundary grain); a freed slot returns
        its pages through the normal release."""
        if self.cancel_probe is None and \
                not any(r.cancel_requested
                        for r in self.scheduler.pending()) and \
                not any(self.cache.slots[s].cancel_requested
                        for s in self.cache.active_slots()):
            return
        for req in list(self.scheduler.pending()):
            if self._cancel_requested(req):
                self.scheduler.remove(req)
                self._finish_disconnect(
                    req, "client disconnected while queued",
                    finished=finished)
        for s in self.cache.active_slots():
            req = self.cache.slots[s]
            if self._cancel_requested(req):
                self._finish_disconnect(
                    req, f"client disconnected in slot {s} after "
                         f"{len(req.out_tokens)} token(s)")
                self._evict(s, req, finished)
