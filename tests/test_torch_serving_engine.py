"""paddle_tpu_torch serving engine against the reference engine
(paddle_tpu.serving, JAX on the CPU), plus the policy and bookkeeping
units mirrored from tests/test_serving_engine.py.

The parity test drives both engines (``kv_layout="contiguous"``) with
the same converted weights, ragged prompts and sampling parameters:
greedy requests and seeded temperature/top-k requests must give the
reference's tokens exactly (f32; sampling draws from the same
per-request numpy stream over logits that agree to ~1e-6).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models.convert import llama_from_jax_state
from paddle_tpu_torch.serving import (EngineIdle, FIFOScheduler, QueueFull,
                                      Request, SamplingParams, ServingEngine,
                                      ServingError, SlotKVCache, bucket_for,
                                      prefill_buckets, sample_token)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py: exact CPU numbers need
    # one intra-op thread in a process that also runs XLA
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    kw = dict(max_position_embeddings=128)
    ref = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny_config(**kw))
    ref.eval()
    state = {n: np.asarray(t._data) for n, t in ref.state_dict().items()}
    port = llama_from_jax_state(state, port_llama.llama_tiny_config(**kw),
                                device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def port_model():
    return port_llama.LlamaForCausalLM(
        port_llama.llama_tiny_config(max_position_embeddings=128),
        device="cpu")


def _prompts(rng, lens, vocab=128):
    return [rng.randint(0, vocab, (n,)).astype(np.int64) for n in lens]


# (prompt length, max_new_tokens, temperature, top_k, seed); all
# prompts share the 16-token bucket, so the reference compiles one
# prefill program
TRAFFIC = [(5, 5, 0.0, 0, None), (9, 3, 0.8, 20, 7), (13, 6, 0.0, 0, None),
           (3, 4, 1.0, 0, None), (11, 5, 0.0, 0, None)]


def test_engine_tokens_match_reference(pair):
    ref, port = pair
    prompts = _prompts(np.random.RandomState(0), [t[0] for t in TRAFFIC])
    outs = []
    for engine_cls, params_cls, model in (
            (JaxServingEngine, JaxSamplingParams, ref),
            (ServingEngine, SamplingParams, port)):
        eng = engine_cls(model, max_slots=2, max_len=64, min_bucket=16,
                         kv_layout="contiguous")
        reqs = [eng.submit(p, max_new_tokens=n,
                           sampling=params_cls(temperature=tmp, top_k=k,
                                               seed=seed))
                for p, (_, n, tmp, k, seed) in zip(prompts, TRAFFIC)]
        eng.run()
        outs.append([(r.output_ids, r.finish_reason) for r in reqs])
    assert outs[1] == outs[0]
    assert [len(o) for o, _ in outs[1]] == [t[1] for t in TRAFFIC]


def test_engine_matches_own_generate(port_model):
    """Bucket-padded prefill + per-row decode reproduce each request's
    bs=1 generate() tokens (the token-identity law)."""
    rng = np.random.RandomState(1)
    prompts = _prompts(rng, [3, 9, 5, 12, 7])
    eng = ServingEngine(port_model, max_slots=2, max_len=64, min_bucket=4)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    for p, req in zip(prompts, reqs):
        want = port_model.generate(torch.as_tensor(p[None]),
                                   max_new_tokens=6)[0, len(p):]
        assert req.output_ids == want.tolist()
    assert eng.cache.free_slots() == [0, 1]


def test_bucket_policy():
    assert bucket_for(1, 4, 64) == 4
    assert bucket_for(5, 4, 64) == 8
    assert bucket_for(33, 4, 64) == 64
    assert bucket_for(50, 4, 48) == 48
    with pytest.raises(ValueError):
        bucket_for(0, 4, 64)
    assert prefill_buckets(4, 64) == [4, 8, 16, 32, 64]
    assert prefill_buckets(24, 100) == [32, 64, 100]
    assert bucket_for(30, 24, 100) in set(prefill_buckets(24, 100))


def test_scheduler_fifo_admission():
    s = FIFOScheduler()
    reqs = [Request(rid=i, prompt=np.zeros(2, np.int64), max_new_tokens=1,
                    sampling=SamplingParams()) for i in range(3)]
    for r in reqs:
        s.add(r)
    got = s.admissions([5, 7])
    assert [(slot, r.rid) for slot, r in got] == [(5, 0), (7, 1)]
    assert s.depth == 1 and s.has_pending()
    assert s.admissions([]) == []
    assert [(sl, r.rid) for sl, r in s.admissions([0, 1])] == [(0, 2)]
    assert not s.has_pending()


def test_sample_token_top_k_truncates():
    logits = np.array([0.0, 5.0, 4.0, 3.0, -1.0])
    rng = np.random.RandomState(0)
    p = SamplingParams(temperature=1.0, top_k=3)
    assert {sample_token(logits, p, rng) for _ in range(60)} <= {1, 2, 3}
    assert sample_token(logits, SamplingParams(), rng) == 1
    with pytest.raises(ValueError):
        SamplingParams(top_k=-1).validate()


def test_slot_cache_lease_cycle():
    c = SlotKVCache(2, 3, 16, 2, 4, torch.float32, torch.device("cpu"))
    assert c.free_slots() == [0, 1, 2] and c.occupancy == 0.0
    c.assign(1, "req")
    assert c.free_slots() == [0, 2] and c.active_slots() == [1]
    with pytest.raises(RuntimeError):
        c.assign(1, "other")
    c.release(1)
    with pytest.raises(RuntimeError):
        c.release(1)
    assert len(c.ks) == 2 and c.ks[0].shape == (3, 16, 2, 4)


def test_typed_admission_errors(port_model):
    eng = ServingEngine(port_model, max_slots=1, max_len=32, max_queue=2)
    with pytest.raises(EngineIdle):
        eng.step()
    prompt = np.arange(1, 5)
    eng.submit(prompt, 2)
    eng.submit(prompt, 2)
    with pytest.raises(QueueFull) as ei:
        eng.submit(prompt, 2)
    assert ei.value.max_queue == 2 and ei.value.depth == 2
    assert isinstance(ei.value, ServingError)
    eng.step()                  # one admitted: a slot frees queue room
    eng.submit(prompt, 2)
    eng.run()
    with pytest.raises(EngineIdle):
        eng.step()
    with pytest.raises(ValueError):
        eng.submit(np.arange(30), 4)          # 30 + 4 - 1 > max_len


def test_eos_deadline_and_drain(port_model):
    rng = np.random.RandomState(5)
    prompt = _prompts(rng, [6])[0]
    probe = ServingEngine(port_model, max_slots=1, max_len=64)
    r0 = probe.submit(prompt, max_new_tokens=8)
    probe.run()
    eos = r0.output_ids[2]
    eng = ServingEngine(port_model, max_slots=1, max_len=64, eos_id=eos)
    r1 = eng.submit(prompt, max_new_tokens=8)
    eng.run()
    assert r1.finish_reason == "eos"
    assert r1.output_ids == r0.output_ids[:r0.output_ids.index(eos) + 1]
    clock = [0.0]
    eng = ServingEngine(port_model, max_slots=1, max_len=64,
                        time_fn=lambda: clock[0])
    late = eng.submit(prompt, max_new_tokens=8, deadline_s=1.0)
    queued = eng.submit(prompt, max_new_tokens=8, deadline_s=1.0)
    eng.step()
    clock[0] = 2.0
    done = eng.step()
    assert {r.finish_reason for r in done} == {"deadline"}
    assert late in done and queued in done
    eng = ServingEngine(port_model, max_slots=1, max_len=64)
    reqs = [eng.submit(prompt, max_new_tokens=8) for _ in range(2)]
    done = eng.drain(max_steps=2)
    assert [r.finish_reason for r in done] == ["cancelled"] * 2
    with pytest.raises(Exception):
        eng.submit(prompt, 2)                 # EngineClosed
    assert all(r.finished for r in reqs)


def test_model_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_llama.LlamaForCausalLM(port_llama.llama_tiny_config())


@pytest.mark.parametrize("kw", [dict(prefill_devices=2),
                                dict(kv_transport=object()),
                                dict(mesh=object()),
                                dict(host_tier_pages=4),
                                dict(kv_host_tier=True,
                                     kv_layout="contiguous"),
                                dict(prefix_store_dir="store")])
def test_later_slice_arguments_raise(port_model, kw, tmp_path):
    """The mesh arguments (the multi-GPU serving slice) raise
    NotImplementedError. The KV tier's are ported and validated as the
    reference validates them: a tier without the paged layout and
    host_tier_pages without a tier raise ValueError, and prefix_store_dir
    builds its store."""
    if "prefix_store_dir" in kw:
        path = str(tmp_path / kw["prefix_store_dir"])
        eng = ServingEngine(port_model, prefix_store_dir=path)
        assert eng.kv_host_tier and eng._kv_tier.store.path == path
        assert os.path.exists(os.path.join(path, "meta.json"))
    elif "host_tier_pages" in kw or "kv_host_tier" in kw:
        with pytest.raises(ValueError):
            ServingEngine(port_model, **kw)
    else:
        with pytest.raises(NotImplementedError):
            ServingEngine(port_model, **kw)


def test_reference_defaults_and_unknown_arguments(port_model):
    ServingEngine(port_model, speculative=False, spec_k=4, mesh=None,
                  prefill_devices=0)
    with pytest.raises(TypeError):
        ServingEngine(port_model, no_such_argument=1)


def test_failed_step_breaks_engine_and_drain_cancels(port_model):
    """A step that fails part-way through its in-place KV writes marks
    the engine broken; drain() then cancels what is left, chaining the
    failure, instead of stranding it."""
    from paddle_tpu_torch.serving import EngineBroken
    eng = ServingEngine(port_model, max_slots=1, max_len=64)
    reqs = [eng.submit(np.arange(1, 6), max_new_tokens=4) for _ in range(2)]

    def boom(ids, caches):
        raise RuntimeError("device fault")
    eng.adapter.call = boom
    with pytest.raises(RuntimeError, match="device fault"):
        eng.step()
    with pytest.raises(EngineBroken):
        eng.step()
    with pytest.raises(EngineBroken):
        eng.submit(np.arange(1, 6), 2)
    done = eng.drain()
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    assert all(r.finish_reason == "cancelled" for r in done)
