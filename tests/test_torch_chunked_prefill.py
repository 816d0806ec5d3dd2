"""paddle_tpu_torch's chunked prefill against the reference engine
(paddle_tpu/serving/engine.py, JAX on the CPU), plus the laws of
tests/test_serving_chunked.py and the chunk metrics of
tests/test_observability.py mirrored on the port.

The model is the reference test's tiny GQA Llama (2 layers, hidden 64,
4 heads over 2 kv heads, 64 positions) drawn by the reference's
initializers from seed 0 and carried across by models/convert.py; f32
on one torch thread, so the identities below are exact:

- the identity band (tests/test_serving_chunked.py:109-158), cut to 10
  seeded waves a layout for time (the reference runs 25): on the
  contiguous and the paged layout (paged waves share a 10-token
  prefix, so prefix-hit admissions chunk too), the port's chunked
  engines at chunk 8, 16 and 64 give the reference engine's greedy
  tokens and the port's unchunked engine's, and every chunk length run
  is a prefill bucket;
- the budget (at most one chunk a step), the mid-chunk terminal paths
  (cancel, deadline, disconnect free the slot and the pages), a chunk
  fault (unwound and requeued; the engine is broken, as every failed
  step breaks the port's engine, and ``recover()`` then gives the
  uninjected tokens), chunked + ``recover()``, chunked + speculative,
  the validation, the admission lookahead;
- paged int8 chunked against paged int8 unchunked: the chunks attend
  over int8 pages where the unchunked prefill attends over the
  unquantized prompt, so greedy tokens may split at near-ties; held to a
  teacher-forced argmax agreement >= 0.95 over the 10 waves (the
  unchunked run's tokens fed back at every step); and paged int8 at
  chunk 8 against the reference engine at chunk 8 (a second reference
  engine; the same einsum route over int8 pages), token for token;
- the chunk metrics and spans (tests/test_observability.py:441-512): the
  registry's chunk families and the ``serving.chunk_prefill`` spans in
  a trace buffer, with request ids.

Every engine ends with empty engine and page leak audits.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.observability import (FlightRecorder, MetricRegistry,
                                            TraceBuffer, install_trace_buffer)
from paddle_tpu_torch.resilience import (ConservationLedger,
                                         engine_leak_violations,
                                         page_leak_violations)
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (ChunkBudgetController, ServingEngine,
                                      prefill_buckets)
from paddle_tpu_torch.serving import engine as engine_mod

TINY = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64)
WAVES = 10                       # the reference band's 25, cut for time
INT8_AGREE_MIN = 0.95


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch, tmp_path):
    faults.clear()
    faults.reset_counts()
    monkeypatch.setenv("PTPU_FLIGHT_DIR", str(tmp_path))
    yield
    faults.clear()


@pytest.fixture(scope="module")
def models():
    """(reference model, port model): the reference test's tiny Llama
    from seed 0, carried across."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.models.convert import llama_from_jax_state
    paddle.seed(0)
    ref = LlamaForCausalLM(llama_tiny_config(**TINY))
    ref.eval()
    state = {n: np.asarray(t._data) for n, t in ref.state_dict().items()}
    return ref, llama_from_jax_state(
        state, port_llama.llama_tiny_config(**TINY), device="cpu")


def _layout_kw(layout):
    return dict(page_size=8) if layout == "paged" \
        else dict(kv_layout="contiguous")


def _wave(rng, n=4, shared=None):
    """The reference band's wave: ragged prompts, some long enough to
    chunk, the even ones sharing a prefix on the paged layout."""
    out = []
    for i in range(n):
        L = int(rng.randint(3, 40))
        p = rng.randint(1, 100, (L,)).astype(np.int64)
        if shared is not None and i % 2 == 0:
            p = np.concatenate([shared, p[:30]]).astype(np.int64)
        out.append(p)
    return out


def _waves(layout):
    shared = np.arange(1, 11, dtype=np.int64)     # > 1 page of 8
    return [_wave(np.random.RandomState(1400 + seed),
                  shared=shared if layout == "paged" else None)
            for seed in range(WAVES)]


def _drive(eng, prompts, max_new=6):
    reqs = [eng.submit(p, max_new) for p in prompts]
    while eng.has_work():
        eng.step()
    return [list(r.out_tokens) for r in reqs]


def _engine(model, layout, **kw):
    return ServingEngine(model, max_slots=3, max_len=64, min_bucket=8,
                         **_layout_kw(layout), **kw)


def _quiesced_ok(eng):
    v = engine_leak_violations(eng) + page_leak_violations(eng)
    assert v == [], "\n".join(v)


@pytest.fixture(scope="module")
def reference_band(models):
    """The reference engine's tokens on every wave of both layouts: ONE
    unchunked paged engine serves the whole band (each of its programs
    compiled once). Without
    prefix sharing, which changes no token: its extend and page-copy
    programs would compile for seconds."""
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    eng = JaxServingEngine(models[0], max_slots=3, max_len=64,
                           min_bucket=8, page_size=8, prefix_sharing=False)
    return {layout: [_drive(eng, w) for w in _waves(layout)]
            for layout in ("contiguous", "paged")}


@pytest.fixture(scope="module")
def reference_int8_chunked(models):
    """The reference engine's tokens on the paged waves with int8 KV and
    chunk 8 (this file's second reference engine): its chunks attend
    over int8 pages through the same einsum route as the port's. Without
    prefix sharing, as above."""
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    eng = JaxServingEngine(models[0], max_slots=3, max_len=64,
                           min_bucket=8, page_size=8, prefix_sharing=False,
                           kv_dtype="int8", prefill_chunk=8)
    return [_drive(eng, w) for w in _waves("paged")]


def _chunk_lengths(eng):
    """Record every chunk's bucket length the engine runs."""
    seen = set()
    run = eng._run_chunk

    def spy(slot, padded, pos, t):
        seen.add(int(padded.shape[1]))
        return run(slot, padded, pos, t)
    eng._run_chunk = spy
    return seen


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunked_identity_band(models, reference_band, layout):
    """Chunked greedy tokens == the reference engine's == the port's
    unchunked engine's, bitwise, on every wave; one engine per chunk size
    serves the whole band, and the chunk lengths stay in the bucket set.
    Chunk 64 == max_len is the degenerate case (every prompt fits one
    chunk)."""
    port_ref = _engine(models[1], layout)
    chunked = {c: _engine(models[1], layout, prefill_chunk=c)
               for c in (8, 16, 64)}
    lengths = {c: _chunk_lengths(e) for c, e in chunked.items()}
    for seed, (wave, want) in enumerate(zip(_waves(layout),
                                            reference_band[layout])):
        assert _drive(port_ref, wave) == want, (layout, seed)
        sizes = (8, 16, 64) if seed % 5 == 0 else ((8, 16, 64)[seed % 3],)
        for c in sizes:
            assert _drive(chunked[c], wave) == want, (layout, seed, c)
    budget = set(prefill_buckets(8, 64))
    for c, eng in chunked.items():
        assert lengths[c] <= budget, (c, lengths[c])
        _quiesced_ok(eng)
    # at chunk 64 a prompt chunks only when the step's budget is spent
    assert lengths[8] and lengths[16]


def test_chunk_budget_caps_tokens_per_step(models):
    """At most one chunk a step while a chunked prefill is in flight,
    and no monolithic prefill past the budget (reference :198)."""
    eng = _engine(models[1], "paged", prefill_chunk=8)
    rng = np.random.RandomState(9)
    r1 = eng.submit(rng.randint(1, 100, (30,)).astype(np.int64), 4)
    r2 = eng.submit(rng.randint(1, 100, (25,)).astype(np.int64), 4)
    eng.step()
    assert r1.prefill_pos is not None and r1.prefill_pos <= 8
    assert r2.prefill_pos == 0
    assert len(eng._chunk_fifo) == 2
    steps = 1
    while eng.has_work():
        eng.step()
        steps += 1
    # 30 + 25 tokens at one 8-token chunk a step, then the decode tail
    assert steps >= 8
    _quiesced_ok(eng)


def _start_chunked(eng, prompt, max_new=4, **submit_kw):
    req = eng.submit(prompt, max_new, **submit_kw)
    eng.step()
    assert req.prefill_pos is not None, "request did not chunk"
    assert not req.finished
    return req


def test_mid_chunk_cancel_frees_slot_and_pages(models):
    led = ConservationLedger()
    eng = _engine(models[1], "paged", prefill_chunk=8, auditor=led)
    rng = np.random.RandomState(11)
    req = _start_chunked(eng, rng.randint(1, 100, (40,)).astype(np.int64))
    assert eng.cancel(req)
    assert req.finished and req.finish_reason == "cancelled"
    assert eng._chunk_fifo == [] and req.slot is None
    while eng.has_work():
        eng.step()
    _quiesced_ok(eng)
    assert led.violations() == []


def test_mid_chunk_deadline_frees_slot_and_pages(models):
    clock = {"t": 0.0}
    led = ConservationLedger()
    eng = _engine(models[1], "paged", prefill_chunk=8,
                  time_fn=lambda: clock["t"], auditor=led)
    rng = np.random.RandomState(12)
    req = _start_chunked(eng, rng.randint(1, 100, (40,)).astype(np.int64),
                         deadline_s=1.0)
    clock["t"] = 5.0            # expires mid-prefill
    while eng.has_work():
        eng.step()
    assert req.finished and req.finish_reason == "deadline"
    assert req.out_tokens == []
    _quiesced_ok(eng)
    assert led.violations() == []


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_mid_chunk_disconnect_frees_slot_and_pages(models, layout):
    """The request's own flag, and the cancel_probe (contiguous)."""
    gone = set()
    led = ConservationLedger()
    eng = _engine(models[1], layout, prefill_chunk=8, auditor=led,
                  cancel_probe=lambda r: r.rid in gone)
    rng = np.random.RandomState(13)
    req = _start_chunked(eng, rng.randint(1, 100, (40,)).astype(np.int64))
    if layout == "paged":
        req.cancel_requested = True
    else:
        gone.add(req.rid)
    while eng.has_work():
        eng.step()
    assert req.finished and req.finish_reason == "disconnect"
    assert eng._m_disconnect.value >= 1
    _quiesced_ok(eng)
    assert led.violations() == []


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunk_fault_unwinds_requeues_and_replays(models, layout):
    """An injected ``serving.prefill.chunk`` fault between chunks unwinds
    the PREFILLING request (slot and pages freed) and requeues it; the
    engine is broken (its other PREFILLING request keeps its slot), and
    after ``recover()`` the re-chunked replay gives the uninjected
    tokens (reference :281)."""
    rng = np.random.RandomState(21)
    prompts = [rng.randint(1, 100, (L,)).astype(np.int64) for L in (35, 20)]
    want = _drive(_engine(models[1], layout, prefill_chunk=8), prompts)
    led = ConservationLedger()
    eng = _engine(models[1], layout, prefill_chunk=8, auditor=led,
                  registry=MetricRegistry())
    reqs = [eng.submit(p, 6) for p in prompts]
    faults.inject("serving.prefill.chunk", times=1, after=2)
    fired = 0
    while eng.has_work():
        try:
            eng.step()
        except faults.InjectedFault:
            fired += 1
            pending = {r.rid for r in eng.scheduler.pending()}
            fifo = {eng.cache.slots[s].rid for s in eng._chunk_fifo}
            assert pending and not (pending & fifo)
            assert eng._broken
            if layout == "paged":
                assert all(r.rid not in eng.cache._plans
                           for r in eng.scheduler.pending())
            eng.recover()
    assert fired == 1
    assert [list(r.out_tokens) for r in reqs] == want
    assert eng._m_recover.value == 1
    _quiesced_ok(eng)
    assert led.violations() == []


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunked_recover_replays_token_identically(models, layout):
    """recover() with PREFILLING requests in flight (reference :315):
    they re-enter the chunk FIFO in its order, from the start, and the
    tokens are the uninjected ones; a request that was admitted through
    the FIFO and is decoding gets its prompt by the same chunks again."""
    rng = np.random.RandomState(23)
    prompts = [rng.randint(1, 100, (L,)).astype(np.int64) for L in (30, 12)]
    want = _drive(_engine(models[1], layout, prefill_chunk=8), prompts)
    eng = _engine(models[1], layout, prefill_chunk=8)
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.step()
    fifo = list(eng._chunk_fifo)
    assert len(fifo) == 2 and reqs[0].prefill_pos == 8
    eng._broken = "test: forced break mid-chunked-prefill"
    assert eng.recover()["recovered_slots"] == 2
    assert eng._chunk_fifo == fifo
    assert [r.prefill_pos for r in reqs] == [0, 0]
    for _ in range(6):               # both decoding, one admitted chunked
        eng.step()
    assert not eng._chunk_fifo and all(r._chunked for r in reqs)
    eng._broken = "test: forced break while decoding"
    assert eng.recover()["replay_mismatches"] == 0
    while eng.has_work():
        eng.step()
    assert [list(r.out_tokens) for r in reqs] == want
    _quiesced_ok(eng)


def test_chunked_composes_with_speculative(models):
    """Chunked prefill + speculative decoding in one engine: the plain
    unchunked k=1 engine's tokens; the PREFILLING slot is skipped by the
    verify until its final chunk (reference :342)."""
    rng = np.random.RandomState(31)
    pat = rng.randint(1, 100, (3,)).astype(np.int64)
    prompts = [np.tile(pat, 12)[:30].astype(np.int64),
               rng.randint(1, 100, (20,)).astype(np.int64)]
    want = _drive(_engine(models[1], "paged"), prompts, max_new=10)
    eng = _engine(models[1], "paged", prefill_chunk=8, speculative=True,
                  spec_k=4)
    lengths = _chunk_lengths(eng)
    assert _drive(eng, prompts, max_new=10) == want
    assert eng.spec_stats()["steps"] > 0
    assert lengths <= set(prefill_buckets(8, 64))
    _quiesced_ok(eng)


def test_prefill_chunk_validation(models):
    """Reference :383, and chunk_control without prefill_chunk."""
    with pytest.raises(ValueError, match="power of 2"):
        _engine(models[1], "paged", prefill_chunk=12)
    with pytest.raises(ValueError, match="bucket"):
        _engine(models[1], "paged", prefill_chunk=4)   # < min_bucket
    with pytest.raises(ValueError, match="admission_lookahead"):
        _engine(models[1], "paged", admission_lookahead=-1)
    with pytest.raises(ValueError, match="chunk_control"):
        _engine(models[1], "paged",
                chunk_control=ChunkBudgetController(
                    registry=MetricRegistry()))


def test_admission_lookahead_relieves_head_of_line(models):
    """With the page pool too small for the queue head, strict FCFS
    (lookahead 0) idles the small request behind it; lookahead 1 admits
    it without losing the head's place (reference :392-450)."""
    rng = np.random.RandomState(51)
    occ_p = rng.randint(1, 100, (33,)).astype(np.int64)
    big_p = rng.randint(1, 100, (40,)).astype(np.int64)
    small_p = rng.randint(1, 100, (5,)).astype(np.int64)

    def build(lookahead):
        # 8 data pages + trash; the occupier (33 + 16: 6 pages) holds
        # the pool, the big head (40 + 4: 6 pages) cannot reserve, the
        # small one (5 + 2: 1 page) can
        eng = ServingEngine(models[1], max_slots=3, max_len=64,
                            min_bucket=8, page_size=8, num_pages=9,
                            prefix_sharing=False,
                            admission_lookahead=lookahead)
        occ = eng.submit(occ_p, 16)
        eng.step()
        return eng, occ, eng.submit(big_p, 4), eng.submit(small_p, 2)

    eng0, occ0, b0, s0 = build(0)
    for _ in range(5):
        eng0.step()
    assert not occ0.finished and s0.out_tokens == [] and not b0.finished
    while eng0.has_work():
        eng0.step()
    assert b0.finished and s0.finished          # not starved forever

    eng1, occ1, b1, s1 = build(1)
    for _ in range(5):
        eng1.step()
    assert not occ1.finished
    assert s1.finished and len(s1.out_tokens) == 2
    assert not b1.finished
    assert eng1.scheduler.pending()[0] is b1    # the head kept its place
    while eng1.has_work():
        eng1.step()
    assert b1.finished
    _quiesced_ok(eng0)
    _quiesced_ok(eng1)


def _forced_agreement(eng, prompts, want):
    """Serve ``prompts`` feeding back ``want``'s tokens at every step
    (teacher forcing); the share of steps whose argmax is that token."""
    reqs = [eng.submit(p, len(w)) for p, w in zip(prompts, want)]
    by_params = {id(r.sampling): (r, w) for r, w in zip(reqs, want)}
    hits = []
    sample = engine_mod.sample_token

    def forced(logits, params, rng):
        req, toks = by_params[id(params)]
        tok = toks[len(req.out_tokens)]
        hits.append(int(np.argmax(logits)) == tok)
        return tok
    engine_mod.sample_token = forced
    try:
        while eng.has_work():
            eng.step()
    finally:
        engine_mod.sample_token = sample
    return hits


@pytest.mark.parametrize("chunk", [8, 16])
def test_paged_int8_chunked_against_unchunked(models, chunk):
    """Paged int8 KV: the chunked engine fed the unchunked engine's
    tokens picks them at >= INT8_AGREE_MIN of its steps over the 10
    waves (the chunks read int8 pages where the unchunked prefill reads
    the unquantized prompt)."""
    kw = dict(kv_dtype="int8")
    plain = _engine(models[1], "paged", **kw)
    chunked = _engine(models[1], "paged", prefill_chunk=chunk, **kw)
    hits = []
    for wave in _waves("paged"):
        want = _drive(plain, wave)
        hits += _forced_agreement(chunked, wave, want)
    assert sum(hits) / len(hits) >= INT8_AGREE_MIN, sum(hits) / len(hits)
    _quiesced_ok(plain)
    _quiesced_ok(chunked)


def test_paged_int8_chunked_against_reference(models,
                                              reference_int8_chunked):
    """Paged int8 KV, chunk 8: the port's chunked tokens equal the
    reference engine's on every paged wave."""
    eng = _engine(models[1], "paged", prefill_chunk=8, kv_dtype="int8",
                  prefix_sharing=False)
    for seed, (wave, want) in enumerate(zip(_waves("paged"),
                                            reference_int8_chunked)):
        assert _drive(eng, wave) == want, seed
    _quiesced_ok(eng)


def test_chunked_prefill_metrics_and_spans(models):
    """A chunked engine publishes the chunk-step counter, the
    chunk-queue depth gauge and the decode-stall histogram in its
    registry, and its spans carry ``serving.chunk_prefill`` with
    request ids (tests/test_observability.py:441-512); an unchunked
    engine registers no chunk family."""
    reg = MetricRegistry()
    eng = ServingEngine(models[1], max_slots=2, max_len=64, min_bucket=8,
                        prefill_chunk=8, registry=reg,
                        flight_recorder=FlightRecorder(capacity=4))
    buf = TraceBuffer(capacity=4096)
    prev = install_trace_buffer(buf)
    try:
        rng = np.random.RandomState(0)
        long_req = eng.submit(rng.randint(1, 100, (40,)).astype(np.int64),
                              max_new_tokens=4)
        short = eng.submit(rng.randint(1, 100, (5,)).astype(np.int64),
                           max_new_tokens=8)
        while eng.has_work():
            eng.step()
    finally:
        install_trace_buffer(prev)
    assert long_req.finished and short.finished
    chunk_steps = reg.counter("ptpu_serving_chunk_steps_total").value
    assert chunk_steps >= 5                    # ceil(40 / 8)
    assert reg.gauge("ptpu_serving_chunk_queue_depth").value == 0
    assert reg.histogram("ptpu_serving_decode_stall_seconds").count >= 1
    text = reg.to_prometheus()
    for fam, kind in (("ptpu_serving_chunk_steps_total", "counter"),
                      ("ptpu_serving_chunk_queue_depth", "gauge"),
                      ("ptpu_serving_decode_stall_seconds", "histogram")):
        assert f"# TYPE {fam} {kind}" in text
    recs = buf.drain()
    chunks = [r for r in recs if r["name"] == "serving.chunk_prefill"]
    assert len(chunks) == chunk_steps
    # the short prompt, admitted behind a PREFILLING one, runs as one
    # whole-prompt chunk
    assert {r["attrs"]["request_id"] for r in chunks} \
        == {long_req.rid, short.rid}
    assert all("chunk" in r["attrs"] and "pos" in r["attrs"]
               for r in chunks)
    assert sum(1 for r in chunks if r["attrs"]["final"]) == 2
    steps = [r for r in recs if r["name"] == "serving.step"]
    assert len(steps) == eng._step_idx
    assert any(r["name"] == "serving.decode" for r in recs)
    reg2 = MetricRegistry()
    ServingEngine(models[1], max_slots=1, max_len=64, registry=reg2,
                  flight_recorder=FlightRecorder(capacity=4))
    assert "ptpu_serving_chunk_steps_total" not in reg2.families()
    assert "ptpu_serving_chunk_queue_depth" not in reg2.families()
    _quiesced_ok(eng)


def test_chunk_budget_controller_drives_the_engine(models):
    """chunk_control raises the per-step budget on a deep queue: more
    than one chunk runs in a step, and the tokens are still the
    unchunked engine's."""
    rng = np.random.RandomState(61)
    prompts = [rng.randint(1, 100, (L,)).astype(np.int64)
               for L in (40, 33, 27, 38, 12, 30)]
    want = _drive(_engine(models[1], "paged"), prompts)
    reg = MetricRegistry()
    ctl = ChunkBudgetController(raise_depth=2.0, lower_depth=0.5,
                                alpha=1.0, dwell=1, registry=reg)
    eng = _engine(models[1], "paged", prefill_chunk=8, chunk_control=ctl,
                  registry=reg)
    per_step = []
    run = eng._run_chunk

    def count(*a):
        per_step[-1] += 1
        return run(*a)
    eng._run_chunk = count
    reqs = [eng.submit(p, 6) for p in prompts]
    while eng.has_work():
        per_step.append(0)
        eng.step()
    assert [list(r.out_tokens) for r in reqs] == want
    assert ctl.adaptations >= 1 and max(per_step) > 1
    _quiesced_ok(eng)
