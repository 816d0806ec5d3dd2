"""paddle_tpu_torch.serving — the continuous-batching serving engine.

Counterpart of ``paddle_tpu/serving`` for the paged KV pool (the
default: copy-on-write prefix sharing, page-gated admission, optional
int8 KV) and the contiguous slot pool: iteration-level FCFS admission
(with an optional bounded lookahead), power-of-2 prefill buckets or
chunked prefill (``prefill_chunk``, with the ``ChunkBudgetController``),
one decode forward per step over every slot (or, with
``speculative=True``, one k-wide verify of n-gram or draft-model
drafts), the host KV tier under the paged pool (``kv_host_tier``, with a
persistent prefix store, ``kv_tier.py``), host-side sampling, typed
errors, fault points, ``recover()`` and ``adopt()``, the metric
registry, spans and the flight recorder.

    engine = ServingEngine(model, max_slots=8, max_len=512)
    req = engine.submit(prompt_ids, max_new_tokens=64)
    done = engine.run()
    print(req.output_ids, engine.metrics.summary(), engine.paged_stats())
"""
from .control import Actuator, ChunkBudgetController
from .engine import ServingEngine
from .errors import (DeadlineExceeded, EngineBroken, EngineClosed,
                     EngineIdle, QueueFull, RequestCancelled, ServingError)
from .metrics import EngineMetrics
from .sampling import SamplingParams, sample_token, sampling_dist
from .scheduler import FIFOScheduler, Request, bucket_for, prefill_buckets
from .slot_cache import PagedKVCache, SlotKVCache
from .spec_decode import DraftModelProposer, NgramProposer
from .spec_tune import SpecTuner

__all__ = ["ServingEngine", "SamplingParams", "sample_token",
           "sampling_dist", "Request", "FIFOScheduler", "bucket_for",
           "prefill_buckets", "SlotKVCache", "PagedKVCache",
           "EngineMetrics", "ServingError", "QueueFull", "DeadlineExceeded",
           "EngineBroken", "EngineIdle", "EngineClosed",
           "RequestCancelled", "NgramProposer", "DraftModelProposer",
           "SpecTuner", "Actuator", "ChunkBudgetController"]
