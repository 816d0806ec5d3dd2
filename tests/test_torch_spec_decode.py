"""paddle_tpu_torch's speculative decoding against the reference's
(paddle_tpu/serving/spec_decode.py, spec_tune.py, the engine's verify
step and models/_decode_cache.py's write lengths, JAX on the CPU), plus
the laws of tests/test_spec_decode.py and tests/test_spec_v2.py
mirrored on the port.

- ``NgramProposer`` gives the reference's proposals on the same
  histories, and ``SpecTuner`` the reference's decisions on the same
  observation stream (both pure host code: exact);
- ``cache_attend`` and ``paged_cache_attend`` with per-row write
  lengths (f32 pages and int8 pages) against the jitted reference:
  outputs within 1e-6 (1e-5 from int8 pages, whose dequantized values
  reach ~13), buffers and pools bit for bit (page 0, the trash page
  nothing reads, aside);
- the engine on the reference's ``--speculative`` CPU trace
  (benchmarks/bench_serving_engine.py: its tiny Llama from seed 0, 4
  slots, max_len 128, page 8, 12 periodic prompts, 48 new tokens, k=4;
  weights carried across by models/convert.py): on both layouts the
  port's tokens equal the reference speculative engine's and the port's
  k=1 engine's, ``spec_stats()`` equals the reference's field for field
  (the n-gram drafts are a function of the tokens), and the reference's
  bars hold (> 1.5 accepted a step, >= 25% fewer steps, hit rate > 0.2,
  multi-token accepts);
- the draft model: self-draft engines on the ``--spec-v2`` CPU trace give
  the k=1 tokens (paged, contiguous, tuned), the draft pool's lifecycle
  (eviction, cancel, deadline, k=1 once full), ``engine_leak_violations``
  empty after each run;
- sampled rows: bitwise the k=1 tokens without ``spec_sampled``, pooled
  total variation < 0.2 against k=1 with it (the reference test's 64
  requests x 12 tokens, an independent draft);
- failures: an EOS inside an accepted run, a verify whose model call
  raises (every over-claimed page returned), a draft model that raises
  (contained to its row), the reference's validation errors.

The cases marked ``cuda`` hold the verify on the card to the k=1 decode
(tokens identical, or else a teacher-forced argmax agreement >= 0.99
with every split a near-tie); they import no JAX, so the file collects
on the card's machine (``--noconftest -m cuda``).

f32 throughout on the CPU, one torch thread (see test_torch_paged_kv.py).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models._decode_cache import (cache_attend,
                                                   paged_cache_attend)
from paddle_tpu_torch.resilience import (engine_leak_violations,
                                         page_leak_violations)
from paddle_tpu_torch.serving import (DraftModelProposer, NgramProposer,
                                      SamplingParams, ServingEngine,
                                      SpecTuner)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# benchmarks/bench_serving_engine.py's CPU model (main(), seed 0)
BENCH = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=256)
# its --speculative CPU settings (:2036-2038)
SPEC_RUN = dict(max_slots=4, max_len=128, min_bucket=8)
SPEC_PAGE, SPEC_REQS, SPEC_NEW, SPEC_K = 8, 12, 48, 4
# its --spec-v2 CPU settings (:2042-2045)
V2_RUN = dict(max_slots=4, max_len=64, min_bucket=8)
V2_REQS, V2_NEW = 8, 12
STATS = ("steps", "gated_steps", "rows", "emitted", "draft_tokens",
         "accepted_draft_tokens", "acc_len_hist")


@pytest.fixture(scope="module")
def models():
    """(reference model, port model): the bench's CPU Llama drawn by the
    reference's initializers from seed 0, carried across."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.convert import llama_from_jax_state
    paddle.seed(0)
    ref = LlamaForCausalLM(LlamaConfig(**BENCH))
    ref.eval()
    state = {n: np.asarray(t._data) for n, t in ref.state_dict().items()}
    return ref, llama_from_jax_state(
        state, port_llama.LlamaConfig(**BENCH), device="cpu")


def _spec_prompts():
    """run_speculative's periodic prompts (seed 0)."""
    rng = np.random.RandomState(0)
    out = []
    for _ in range(SPEC_REQS):
        pat = rng.randint(1, 100, (int(rng.randint(1, 4)),)).astype(np.int64)
        L = int(rng.randint(8, 24))
        out.append(np.tile(pat, L // len(pat) + 1)[:L])
    return out


def _v2_prompts():
    """run_spec_v2's low-self-similarity prompts (seed 0)."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, 100, (int(rng.choice([6, 9, 14, 22])),))
            .astype(np.int64) for _ in range(V2_REQS)]


def _serve(engine_cls, model, prompts, new, **kw):
    """Every prompt at once, drained: (tokens, engine, steps)."""
    eng = engine_cls(model, **kw)
    reqs = [eng.submit(p, new) for p in prompts]
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
    return [r.output_ids for r in reqs], eng, steps


def _quiesced_ok(eng):
    v = engine_leak_violations(eng) + page_leak_violations(eng)
    assert v == [], "\n".join(v)


@pytest.fixture(scope="module")
def reference_spec(models):
    """The reference's paged n-gram engine on the --speculative trace:
    (tokens, spec_stats, steps). Without prefix sharing (the trace shares
    one token): its extend and page-copy programs would compile for
    ~1.3 s, and sharing changes neither tokens nor drafts."""
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    outs, eng, steps = _serve(JaxServingEngine, models[0], _spec_prompts(),
                              SPEC_NEW, page_size=SPEC_PAGE,
                              prefix_sharing=False, speculative=True,
                              spec_k=SPEC_K, **SPEC_RUN)
    return outs, eng.spec_stats(), steps


@pytest.fixture(scope="module")
def k1_spec(models):
    """The port's k=1 paged engine on the --speculative trace."""
    outs, _, steps = _serve(ServingEngine, models[1], _spec_prompts(),
                            SPEC_NEW, page_size=SPEC_PAGE, **SPEC_RUN)
    return outs, steps


@pytest.fixture(scope="module")
def k1_v2(models):
    return _serve(ServingEngine, models[1], _v2_prompts(), V2_NEW,
                  **V2_RUN)[0]


# -- the n-gram proposer --------------------------------------------------

def _histories(seed: int):
    """Periodic, random and mixed token histories."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(12):
        L = int(rng.randint(2, 40))
        if i % 3 == 0:
            out.append(rng.randint(1, 20, (L,)))
        else:
            pat = rng.randint(1, 50, (int(rng.randint(1, 5)),))
            h = np.tile(pat, L // len(pat) + 1)[:L]
            if i % 3 == 2:
                h[rng.randint(0, L)] = 77
            out.append(h)
    return [h.astype(np.int64) for h in out]


@pytest.mark.parametrize("ngram,max_draft,min_ngram",
                         [(2, 3, 1), (3, 5, 2), (1, 2, 1)])
def test_ngram_proposals_match_reference(ngram, max_draft, min_ngram):
    """Fed incrementally, one cut at a time, and once more with a shrunk
    history and a capped ``max_tokens``: the port's drafts are the
    reference's."""
    from paddle_tpu.serving.spec_decode import NgramProposer as JaxNgram
    kw = dict(ngram=ngram, max_draft=max_draft, min_ngram=min_ngram)
    port, ref = NgramProposer(**kw), JaxNgram(**kw)
    drafted = 0
    for rid, h in enumerate(_histories(ngram * 10 + max_draft)):
        for cut in range(len(h) + 1):
            want = ref.propose(rid, h[:cut])
            got = port.propose(rid, h[:cut])
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.int64
            drafted += int(len(got) > 0)
        np.testing.assert_array_equal(port.propose(rid, h[:len(h) // 2]),
                                      ref.propose(rid, h[:len(h) // 2]))
        np.testing.assert_array_equal(port.propose(rid, h, 1),
                                      ref.propose(rid, h, 1))
    assert port.tracked() == ref.tracked()
    assert drafted > 50


def test_ngram_proposer_validation():
    with pytest.raises(ValueError, match="ngram"):
        NgramProposer(ngram=0)
    with pytest.raises(ValueError, match="min_ngram"):
        NgramProposer(ngram=2, min_ngram=3)
    with pytest.raises(ValueError, match="max_draft"):
        NgramProposer(max_draft=-1)


def test_ngram_proposer_deterministic_and_incremental():
    ids = np.array([7, 8, 9, 7, 8, 9, 7, 8], np.int64)
    a, b = NgramProposer(ngram=2, max_draft=3), NgramProposer(ngram=2,
                                                             max_draft=3)
    d1 = a.propose(0, ids)
    np.testing.assert_array_equal(d1, a.propose(0, ids))
    for cut in range(4, len(ids) + 1):
        d3 = b.propose(1, ids[:cut])
    np.testing.assert_array_equal(d1, d3)
    assert list(d1) == [9, 7, 8]


def test_ngram_proposer_empty_short_backoff_and_no_match():
    p = NgramProposer(ngram=2, max_draft=3)
    assert p.propose(0, np.zeros((0,), np.int64)).size == 0
    assert p.propose(0, np.array([5], np.int64)).size == 0
    assert p.propose(0, np.arange(1, 12, dtype=np.int64)).size == 0
    rep = np.array([3, 3, 3, 3], np.int64)
    assert p.propose(0, rep, max_tokens=0).size == 0
    assert p.propose(0, rep).size > 0
    q = NgramProposer(ngram=2, max_draft=2, min_ngram=1)
    assert list(q.propose(0, np.array([9, 4, 4], np.int64))) == [4]


def test_ngram_proposer_hit_rate_floor():
    rng = np.random.RandomState(0)
    seq = np.tile(rng.randint(1, 100, (4,)), 16).astype(np.int64)
    p = NgramProposer(ngram=2, max_draft=3)
    hits = total = 0
    for cut in range(10, len(seq)):
        d = p.propose(0, seq[:cut])
        if len(d):
            total += 1
            hits += int(d[0] == seq[cut])
    assert total >= 40 and hits / total >= 0.95, (hits, total)


def test_ngram_proposer_release_retain_and_shrunk_history():
    p = NgramProposer(ngram=2, max_draft=2)
    rep = np.array([1, 2, 1, 2, 1], np.int64)
    for rid in (3, 4, 5):
        p.propose(rid, rep)
    assert p.tracked() == [3, 4, 5]
    p.release(4)
    p.release(4)
    assert p.tracked() == [3, 5]
    p.retain([5])
    assert p.tracked() == [5]
    p.retain(())
    assert p.tracked() == []
    p.propose(0, np.array([1, 2, 3, 1, 2, 3, 1, 2], np.int64))
    assert list(p.propose(0, np.array([7, 8, 7, 8, 7], np.int64))) == [8, 7]


# -- the tuner -----------------------------------------------------------

@pytest.mark.parametrize("knobs", [
    dict(k_max=4, proposers=("ngram",)),
    dict(k_max=6, proposers=("draft", "ngram"), dwell=2, probe_every=4,
         switch_margin=0.3),
    dict(k_max=3, proposers=("ngram", "draft"), alpha=0.5, dwell=1,
         probe_every=3, enable_at=1.6, disable_at=1.2)])
def test_tuner_matches_reference_decisions(knobs):
    """One observation stream, accepted lengths that drift from paying
    to not and back, into both tuners: every decision and every
    snapshot are the reference's."""
    from paddle_tpu.serving.spec_tune import SpecTuner as JaxTuner
    port, ref = SpecTuner(**knobs), JaxTuner(**knobs)
    rng = np.random.RandomState(knobs["k_max"])
    for step in range(300):
        phase = (step // 60) % 3            # pays, does not, pays again
        for klass in ("greedy", "sampled"):
            got, want = port.decide(klass), ref.decide(klass)
            assert got == want, (step, klass)
            k, kind = got
            if kind is None:
                continue
            hi = k + 1 if phase != 1 else 2
            acc = int(rng.randint(1, hi))
            port.observe(klass, kind, acc)
            ref.observe(klass, kind, acc)
        port.on_step()
        ref.on_step()
        assert port.snapshot() == ref.snapshot(), step
    assert port.flips == ref.flips and port.flips > 0


def test_tuner_validation():
    with pytest.raises(ValueError, match="k_max"):
        SpecTuner(k_max=1)
    with pytest.raises(ValueError, match="proposer"):
        SpecTuner(k_max=4, proposers=())
    with pytest.raises(ValueError, match="alpha"):
        SpecTuner(k_max=4, alpha=0.0)
    with pytest.raises(ValueError, match="dead band"):
        SpecTuner(k_max=4, enable_at=1.2, disable_at=1.4)


def test_tuner_dwell_probe_reenable_switch_and_classes():
    """tests/test_spec_v2.py's four tuner laws in one pass."""
    t = SpecTuner(k_max=4, dwell=4, probe_every=8)
    assert t.decide("greedy") == (4, "ngram")
    for _ in range(3):
        t.observe("greedy", "ngram", 1)
        t.on_step()
        assert t.decide("greedy")[1] == "ngram"     # the dwell gate
    t.observe("greedy", "ngram", 1)
    t.on_step()
    assert t.flips == 1 and t.decide("greedy") == (1, None)
    probed = 0
    for step in range(t._step, t._step + 16):
        k, kind = t.decide("greedy")
        assert (k, kind) == ((2, "ngram") if step % 8 == 0 else (1, None))
        probed += k == 2
        t.on_step()
    assert probed == 2
    t = SpecTuner(k_max=6, dwell=2, probe_every=4)
    for _ in range(4):
        t.observe("greedy", "ngram", 1)
        t.on_step()
    while not t.snapshot()["classes"]["greedy"]["on"]:
        if t.decide("greedy")[0] == 2:
            t.observe("greedy", "ngram", 4)
        t.on_step()
        assert t._step < 200
    assert 2 <= t.snapshot()["classes"]["greedy"]["k"] <= 6
    assert t.flips == 2
    t = SpecTuner(k_max=4, proposers=("ngram", "draft"), dwell=1,
                  switch_margin=0.5)
    t.observe("greedy", "ngram", 2)
    t.observe("greedy", "draft", 2)
    t.on_step()
    assert t.snapshot()["classes"]["greedy"]["kind"] == "ngram"
    for _ in range(3):
        t.observe("greedy", "draft", 4)
        t.on_step()
    assert t.snapshot()["classes"]["greedy"]["kind"] == "draft"
    t = SpecTuner(k_max=4, dwell=1)
    for _ in range(4):
        t.observe("greedy", "ngram", 4)
        t.observe("sampled", "ngram", 1)
        t.on_step()
    s = t.snapshot()["classes"]
    assert s["greedy"]["on"] is True and s["sampled"]["on"] is False


# -- the attends with write lengths against the jitted reference ----------

def test_cache_attend_write_lengths_match_reference():
    """Per-row positions, write lengths 0 (an inactive row) to t, rows
    whose window runs past the buffer: the outputs of the written tokens
    within 1e-6, the buffers bit for bit (positions past wlen keep their
    values, as the reference's dropped scatter leaves them)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import _decode_cache as jax_dc
    b, t, h, kv, D, Tmax = 5, 4, 4, 2, 8, 16
    rng = np.random.RandomState(0)
    qr = rng.standard_normal((b, t, h, D)).astype(np.float32)
    kr, v = (rng.standard_normal((b, t, kv, D)).astype(np.float32)
             for _ in range(2))
    kc, vc = (rng.standard_normal((b, Tmax, kv, D)).astype(np.float32)
              for _ in range(2))
    pos = np.array([3, 0, 14, 13, 15], np.int32)
    wlen = np.array([4, 0, 2, 3, 1], np.int32)
    fn = jax.jit(lambda *a: jax_dc.cache_attend(*a[:6], True, wlen=a[6]))
    want = fn(*(jnp.asarray(a) for a in (qr, kr, v, kc, vc, pos, wlen)))
    got = cache_attend(*(torch.from_numpy(a.copy())
                         for a in (qr, kr, v, kc, vc)),
                       torch.from_numpy(pos).long(), True,
                       wlen=torch.from_numpy(wlen).long())
    for r in range(b):
        np.testing.assert_allclose(got[0].numpy()[r, :wlen[r]],
                                   np.asarray(want[0])[r, :wlen[r]],
                                   atol=1e-6, rtol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_cache_attend_write_lengths_match_reference(quant):
    """The verify's paged form: per-row positions and write lengths, an
    inactive row (wlen 0, trash page 0), a window past the table."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.models import _decode_cache as jax_dc
    b, t, h, kv, D, page, npg, num_pages = 4, 4, 4, 2, 8, 8, 3, 14
    rng = np.random.RandomState(1 + quant)
    qr = rng.standard_normal((b, t, h, D)).astype(np.float32)
    kr, v = (rng.standard_normal((b, t, kv, D)).astype(np.float32)
             for _ in range(2))
    pshape = (num_pages, page, kv, D)
    if quant:
        kp, vp = (rng.randint(-127, 128, pshape).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.1, pshape[:3]).astype(np.float32)
                  for _ in range(2))
    else:
        kp, vp = (rng.standard_normal(pshape).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    table = rng.permutation(np.arange(1, num_pages))[:b * npg]
    table = table.reshape(b, npg).astype(np.int32)
    table[1] = 0                            # the inactive row
    pos = np.array([6, 0, 21, 22], np.int32)
    wlen = np.array([4, 0, 3, 2], np.int32)
    fn = jax.jit(jax_dc.paged_cache_attend, static_argnames=("out_dtype",))
    arrays = (qr, kr, v, kp, vp, ks, vs)
    want = fn(*(None if a is None else jnp.asarray(a) for a in arrays),
              jnp.asarray(table), jnp.asarray(pos), out_dtype=jnp.float32,
              wlen=jnp.asarray(wlen))
    got = paged_cache_attend(
        *(None if a is None else torch.from_numpy(a.copy())
          for a in arrays), torch.from_numpy(table),
        torch.from_numpy(pos).long(), torch.float32,
        wlen=torch.from_numpy(wlen).long())
    # int8: dequantized values up to ~13, summed in another order
    tol = 1e-5 if quant else 1e-6
    for r in range(b):
        np.testing.assert_allclose(got[0].numpy()[r, :wlen[r]],
                                   np.asarray(want[0])[r, :wlen[r]],
                                   atol=tol, rtol=tol)
    for g, w, name in zip(got[1:], want[1:], ("kp", "vp", "ks", "vs")):
        if g is None:
            assert w is None
            continue
        np.testing.assert_array_equal(
            g.numpy()[1:].view(np.uint8), np.asarray(w)[1:].view(np.uint8),
            err_msg=name)


# -- the n-gram engine against the reference's ----------------------------

@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_ngram_engine_matches_reference(models, reference_spec, k1_spec,
                                        layout):
    ref_outs, ref_stats, ref_steps = reference_spec
    kw = dict(page_size=SPEC_PAGE) if layout == "paged" \
        else dict(kv_layout="contiguous")
    outs, eng, steps = _serve(ServingEngine, models[1], _spec_prompts(),
                              SPEC_NEW, speculative=True, spec_k=SPEC_K,
                              **kw, **SPEC_RUN)
    assert outs == ref_outs
    assert outs == k1_spec[0]
    st = eng.spec_stats()
    assert {k: st[k] for k in STATS} == {k: ref_stats[k] for k in STATS}
    assert steps == ref_steps
    assert st["draft_faults"] == 0 and st["proposer"] == "ngram"
    # the reference's --speculative bars (tests/test_benchmarks_smoke.py)
    assert st["accepted_per_step"] > 1.5, st
    assert 1.0 - steps / k1_spec[1] >= 0.25, (steps, k1_spec[1])
    assert st["draft_hit_rate"] > 0.2, st
    assert sum(st["acc_len_hist"][2:]) > 0, st
    _quiesced_ok(eng)


def test_int8_kv_ngram_engine_matches_int8_k1(models):
    """int8 pages: a rejected draft's write touches only its own
    positions' codes and scales, so the speculative int8 engine's tokens
    are the int8 k=1 engine's."""
    kw = dict(page_size=SPEC_PAGE, kv_dtype="int8", **SPEC_RUN)
    prompts = _spec_prompts()[:8]
    base = _serve(ServingEngine, models[1], prompts, 24, **kw)[0]
    outs, eng, _ = _serve(ServingEngine, models[1], prompts, 24,
                          speculative=True, **kw)
    assert outs == base
    assert eng.spec_stats()["accepted_draft_tokens"] > 0
    _quiesced_ok(eng)


def test_spec_stats_and_argument_validation(models):
    model = models[1]
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(model, max_slots=1, max_len=32, speculative=True,
                      spec_k=1)
    with pytest.raises(ValueError, match="spec_proposer"):
        ServingEngine(model, max_slots=1, max_len=32, speculative=True,
                      spec_proposer="medusa")
    with pytest.raises(ValueError, match="draft_model="):
        ServingEngine(model, max_slots=1, max_len=32, speculative=True,
                      spec_proposer="draft")
    for kw in ({"spec_k": 8}, {"spec_proposer": "draft"},
               {"draft_model": model}, {"spec_sampled": True},
               {"spec_tune": True}, {"spec_gate": False},
               {"spec_ngram": 3}):
        with pytest.raises(ValueError, match="speculative=True"):
            ServingEngine(model, max_slots=1, max_len=32, **kw)
    with pytest.raises(RuntimeError):
        ServingEngine(model, max_slots=1, max_len=32).spec_stats()
    with pytest.raises(ValueError, match="max_slots"):
        DraftModelProposer(model, max_slots=0, max_len=32)
    with pytest.raises(ValueError, match="max_draft"):
        DraftModelProposer(model, max_slots=1, max_len=32, max_draft=-1)
    with pytest.raises(ValueError, match="positions"):
        DraftModelProposer(model, max_slots=1, max_len=512)


def test_eos_stops_inside_accepted_run(models):
    model = models[1]
    rng = np.random.RandomState(5)
    prompt = np.tile(rng.randint(1, 100, (2,)), 5).astype(np.int64)
    probe = ServingEngine(model, max_slots=1, max_len=64, min_bucket=8)
    r0 = probe.submit(prompt, max_new_tokens=10)
    probe.run()
    multi = 0
    for cut in range(2, len(r0.output_ids)):
        eos = r0.output_ids[cut]
        eng = ServingEngine(model, max_slots=1, max_len=64, min_bucket=8,
                            speculative=True, spec_k=4, eos_id=eos)
        r1 = eng.submit(prompt, max_new_tokens=10)
        eng.run()
        stop = r0.output_ids.index(eos)
        assert r1.output_ids == r0.output_ids[:stop + 1], cut
        assert r1.finish_reason == "eos"
        multi += sum(eng.spec_stats()["acc_len_hist"][2:])
        _quiesced_ok(eng)
    assert multi > 0                        # accepted runs really formed


def test_sampled_rows_gated_and_ungated_match_k1(models):
    """A sampled row without spec_sampled rides position 0's logits on
    its own RNG stream: the k=1 tokens through the gate (the k=1 decode)
    and through the verify at write length 1."""
    rng = np.random.RandomState(7)
    prompt = rng.randint(1, 100, (6,)).astype(np.int64)
    outs = []
    for kw in ({}, {"speculative": True},
               {"speculative": True, "spec_gate": False}):
        eng = ServingEngine(models[1], max_slots=2, max_len=64,
                            min_bucket=8, **kw)
        r = eng.submit(prompt, max_new_tokens=8, sampling=SamplingParams(
            temperature=0.8, top_k=20, seed=11))
        eng.run()
        outs.append(r.output_ids)
        if kw:
            st = eng.spec_stats()
            assert st["draft_tokens"] == 0
            assert (st["gated_steps"] > 0) == kw.get("spec_gate", True)
            assert (st["steps"] > 0) != kw.get("spec_gate", True)
    assert outs[0] == outs[1] == outs[2]


def test_failed_verify_returns_overclaimed_pages(models, monkeypatch):
    """A verify claims its whole k-wide window's pages up front
    (ensure_decode_range). When its model call raises, every page past
    the one holding the next write position goes back: the pool's free
    pages and reservation budget are what they were before the step;
    the engine is then broken, and drain() leaves nothing behind."""
    from paddle_tpu_torch.observability import MetricRegistry
    kw = dict(max_slots=1, max_len=64, min_bucket=8, page_size=8)
    # its own registry: the accepted-length histogram's buckets follow
    # spec_k, and the default registry holds spec_k=4's
    eng = ServingEngine(models[1], speculative=True, spec_k=8,
                        registry=MetricRegistry(), **kw)
    h = eng.submit(np.arange(1, 13).astype(np.int64), max_new_tokens=10)
    prop = eng.proposer
    monkeypatch.setattr(prop, "propose",
                        lambda rid, ids, k: np.zeros((0,), np.int64))
    while len(h.output_ids) < 2:
        eng.step()
    req = eng.cache.slots[0]
    last_page = (req.next_pos + eng.spec_k - 1) // 8
    assert last_page > req.next_pos // 8
    assert int(eng.cache.page_table[0][last_page]) == 0
    monkeypatch.setattr(prop, "propose", lambda rid, ids, k: np.arange(
        1, 1 + k, dtype=np.int64))
    free0, comm0 = eng.cache.free_page_count(), eng.cache.committed_pages
    row0 = eng.cache.page_table[0].copy()
    call = eng.adapter.call

    def failing(ids, caches, **kw):
        if ids.shape[1] > 1:
            raise RuntimeError("verify forward failed")
        return call(ids, caches, **kw)
    monkeypatch.setattr(eng.adapter, "call", failing)
    with pytest.raises(RuntimeError, match="verify forward failed"):
        eng.step()
    assert eng.cache.free_page_count() == free0
    assert eng.cache.committed_pages == comm0
    np.testing.assert_array_equal(eng.cache.page_table[0], row0)
    done = eng.drain()
    assert h in done and h.finish_reason == "cancelled"
    _quiesced_ok(eng)


# -- the draft model -------------------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"kv_layout": "contiguous"},
                                   {"spec_tune": True}],
                         ids=["paged", "contiguous", "tuned"])
def test_self_draft_engine_gives_k1_tokens(models, k1_v2, extra):
    """run_spec_v2's self-draft: the target drafts for itself through the
    draft proposer's own pool; the tokens are the k=1 engine's and
    nearly every draft lands."""
    outs, eng, _ = _serve(ServingEngine, models[1], _v2_prompts(), V2_NEW,
                          speculative=True, spec_proposer="draft",
                          draft_model=models[1], **extra, **V2_RUN)
    assert outs == k1_v2
    st = eng.spec_stats()
    assert st["draft_faults"] == 0
    assert st["accepted_per_step"] > 1.5, st
    assert eng.metrics.summary()["spec_draft_s"] > 0
    if extra.get("spec_tune"):
        g = st["tuner"]["classes"]["greedy"]
        assert g["on"] and g["kind"] == "draft" and g["k"] >= 2
    draft = eng._proposers["draft"]
    assert draft.free_slots() == draft.max_slots
    _quiesced_ok(eng)


def _tiny_draft():
    """An independent draft model (narrower, its own weights): it often
    disagrees with the target."""
    cfg = port_llama.llama_tiny_config(
        hidden_size=32, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=2, max_position_embeddings=128)
    return port_llama.LlamaForCausalLM(
        cfg, device="cpu", generator=torch.Generator().manual_seed(7))


def test_draft_pool_lifecycle_and_degrade(models):
    p = DraftModelProposer(models[1], max_slots=2, max_len=64, max_draft=2)
    rng = np.random.RandomState(1)
    ids = [rng.randint(1, 100, (6,)).astype(np.int64) for _ in range(3)]
    assert len(p.propose(10, ids[0])) > 0
    assert len(p.propose(11, ids[1])) > 0
    assert p.tracked() == [10, 11] and p.free_slots() == 0
    assert p.propose(12, ids[2]).size == 0      # pool full: k=1
    p.release(10)
    p.release(10)
    assert p.free_slots() == 1
    assert len(p.propose(12, ids[2])) > 0
    p.retain([12])
    assert p.tracked() == [12] and p.leased_slots() == [0]
    p.reset()
    assert p.tracked() == [] and p.free_slots() == 2 and p._ks is None
    q = DraftModelProposer(models[1], max_slots=1, max_len=16, max_draft=3)
    assert q.propose(0, np.zeros((0,), np.int64)).size == 0
    assert q.propose(0, np.array([5], np.int64), max_tokens=0).size == 0
    assert q.propose(0, np.arange(1, 17, dtype=np.int64)).size == 0


def test_draft_pool_freed_on_eviction_cancel_and_deadline(models):
    clock = {"t": 0.0}
    eng = ServingEngine(models[1], max_slots=3, max_len=64, min_bucket=8,
                        speculative=True, spec_proposer="draft",
                        draft_model=_tiny_draft(), time_fn=lambda: clock["t"])
    draft = eng._proposers["draft"]
    prompts = _v2_prompts()
    a = eng.submit(prompts[0], max_new_tokens=4)
    b = eng.submit(prompts[1], max_new_tokens=20)
    c = eng.submit(prompts[2], max_new_tokens=20, deadline_s=5.0)
    eng.step()
    eng.step()
    assert set(draft.tracked()) == {a.rid, b.rid, c.rid}
    assert draft.free_slots() == 0
    eng.cancel(b)
    assert b.rid not in draft.tracked() and draft.free_slots() == 1
    clock["t"] = 99.0
    done = eng.step()
    assert c in done and c.finish_reason == "deadline"
    assert c.rid not in draft.tracked()
    assert engine_leak_violations(eng) == [] or a.slot is not None
    eng.run()
    assert a.finish_reason == "length"
    assert draft.tracked() == [] and draft.free_slots() == 3
    _quiesced_ok(eng)


def test_draft_model_fault_contained_to_its_row(models, k1_v2, monkeypatch):
    """A draft model that raises costs its row's window for one step:
    the row runs at k=1, draft_faults counts it, the proposer's pool is
    reset, drafting resumes, and the tokens stay the k=1 engine's."""
    eng = ServingEngine(models[1], speculative=True, spec_proposer="draft",
                        draft_model=models[1], **V2_RUN)
    draft = eng._proposers["draft"]
    forward = draft._forward
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] in (5, 40):
            raise RuntimeError("draft forward failed")
        return forward(*a)
    monkeypatch.setattr(draft, "_forward", flaky)
    reqs = [eng.submit(p, V2_NEW) for p in _v2_prompts()]
    eng.run()
    assert [r.output_ids for r in reqs] == k1_v2
    st = eng.spec_stats()
    assert st["draft_faults"] == 2
    assert st["accepted_draft_tokens"] > 0
    _quiesced_ok(eng)


# -- sampled rows ------------------------------------------------------------

def _sampled_tokens(model, n_req, new, **kw):
    """tests/test_spec_v2.py's pooled token histogram over seeded sampled
    requests (3 slots, max_len 64)."""
    eng = ServingEngine(model, max_slots=3, max_len=64, min_bucket=8, **kw)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 100, (int(rng.randint(4, 9)),))
               .astype(np.int64) for _ in range(n_req)]
    reqs = [eng.submit(p, max_new_tokens=new, sampling=SamplingParams(
        temperature=0.8, top_k=8, seed=1000 + i))
        for i, p in enumerate(prompts)]
    eng.run()
    toks = [t for r in reqs for t in r.output_ids]
    return np.bincount(np.asarray(toks, np.int64), minlength=128), eng


def test_sampled_rows_bitwise_without_spec_sampled(models):
    base, _ = _sampled_tokens(models[1], 6, 8)
    spec, eng = _sampled_tokens(models[1], 6, 8, speculative=True,
                                spec_proposer="draft",
                                draft_model=_tiny_draft())
    np.testing.assert_array_equal(base, spec)
    assert eng.spec_stats()["draft_tokens"] == 0


def test_sampled_acceptance_distribution_parity(models):
    """Rejection sampling against an independent draft keeps the k=1
    distribution: pooled TV < 0.2 over 64 requests x 12 tokens, with
    drafts accepted and the residual resample firing."""
    base, _ = _sampled_tokens(models[1], 64, 12)
    spec, eng = _sampled_tokens(models[1], 64, 12, speculative=True,
                                spec_proposer="draft",
                                draft_model=_tiny_draft(),
                                spec_sampled=True)
    tv = 0.5 * float(np.abs(base / base.sum() - spec / spec.sum()).sum())
    assert tv < 0.2, tv
    st = eng.spec_stats()
    assert st["accepted_draft_tokens"] > 0 and st["resamples"] > 0, st
    _quiesced_ok(eng)


# -- on the card -------------------------------------------------------------

def _cuda_model():
    cfg = port_llama.llama_tiny_config(
        vocab_size=256, hidden_size=256, num_attention_heads=2,
        num_hidden_layers=2, intermediate_size=512,
        max_position_embeddings=256)
    return port_llama.LlamaForCausalLM(
        cfg, device="cuda", dtype="bfloat16",
        generator=torch.Generator(device="cuda").manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{}, {"kv_layout": "contiguous"},
                                   {"kv_dtype": "int8"}],
                         ids=["paged", "contiguous", "paged-int8"])
def test_cuda_verify_matches_k1_decode(extra):
    """The k-wide verify in bf16 on the card against the k=1 decode of
    the same layout: tokens identical, or else, with the k=1 tokens fed
    to the verify as drafts (teacher forcing), its argmax agrees at
    >= 99% of the positions and every split is a near-tie (the k=1
    token's logit within one bf16 step of the verify's maximum)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _cuda_model()
    prompts = _spec_prompts()
    kw = dict(max_slots=4, max_len=128, min_bucket=16, **extra)
    base = _serve(ServingEngine, model, prompts, 32, **kw)[0]
    outs, eng, _ = _serve(ServingEngine, model, prompts, 32,
                          speculative=True, **kw)
    assert eng.spec_stats()["draft_faults"] == 0
    _quiesced_ok(eng)
    if outs == base:
        return
    hits, gaps = _teacher_forced(model, prompts, base, kw)
    assert np.mean(hits) >= 0.99, np.mean(hits)
    assert all(g <= s for g, s in gaps), gaps


def _teacher_forced(model, prompts, base, kw):
    """The verify fed the k=1 run's tokens as its drafts, and each step
    emitting them whatever it predicts: whether its argmax is the k=1
    token at each written position, and at each split the (logit gap,
    bf16 step) pair."""
    eng = ServingEngine(model, speculative=True, spec_gate=False, **kw)
    reqs = [eng.submit(p, len(b)) for p, b in zip(prompts, base)]
    want = {r.rid: b for r, b in zip(reqs, base)}
    plen = {r.rid: r.prompt_len for r in reqs}
    drafted = {}

    def oracle(rid, ids, k):
        n = len(ids) - plen[rid]
        drafted[rid] = np.asarray(want[rid][n:n + k], np.int64)
        return drafted[rid]
    eng.proposer.propose = oracle
    hits, gaps = [], []

    def forced(slot, req, greedy_row, acc, logits_row, draft=None, qs=None):
        ref = want[req.rid]
        n = len(req.out_tokens)
        for j in range(1 + len(drafted.pop(req.rid, ()))):
            tok = ref[n + j]
            hits.append(int(greedy_row[j]) == tok)
            if not hits[-1]:
                row = logits_row[j]
                step = 2.0 ** (np.floor(np.log2(np.abs(row).max())) - 7)
                gaps.append((float(row.max() - row[tok]), float(step)))
            req.out_tokens.append(tok)
            eng.metrics.on_token(req.rid)
            if eng._is_finished(req, tok):
                break
        return len(req.out_tokens) - n
    eng._emit_verified = forced
    eng.run()
    return hits, gaps
