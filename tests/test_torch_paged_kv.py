"""paddle_tpu_torch's paged KV layout against the reference's
(paddle_tpu/models/_decode_cache.py, serving/slot_cache.PagedKVCache and
the engine's paged path, JAX on the CPU), plus the laws of
tests/test_paged_kv.py mirrored on the port.

- ``quantize_kv_page``: codes and scales bit for bit against the jitted
  reference (XLA's ``amax * f32(1/127)``);
- ``paged_cache_attend``: decode (per-row positions, an inactive row on
  trash page 0) and extend (a scalar start, bucket padding past the
  table), model dtype and int8, MHA and GQA: outputs within 1e-6 in
  f32, pools bit for bit (page 0, the trash page nothing reads, aside);
- the paged engine on one ragged trace (a same-wave shared prefix, then
  the A/B/C share trio: divergence at a page boundary and mid-page)
  under a pool small enough to reclaim cached pages: the port's tokens,
  ``paged_stats()`` counters and cached pages equal the reference
  engine's, in model dtype (MHA) and int8 (GQA);
- port-only laws: paged equals contiguous tokens without sharing,
  geometry and argument validation, refcounts released on deadline,
  ``cancel()`` and ``drain()``, a failed prefill leaving no leak,
  admission gated by pages, LRU reclaim, the rope-table overrun of the
  extend, the int8 pools. Each engine ends with no page leak.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import _decode_cache as jax_dc
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.nn import initializer as jax_init
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models._decode_cache import (paged_cache_attend,
                                                   quantize_kv_page)
from paddle_tpu_torch.models.convert import llama_from_jax_state
from paddle_tpu_torch.resilience import page_leak_violations
from paddle_tpu_torch.serving import (EngineBroken, FIFOScheduler,
                                      PagedKVCache, Request,
                                      SamplingParams, ServingEngine)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py: exact CPU numbers need
    # one intra-op thread in a process that also runs XLA
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# deliberately minuscule (1 layer, d=32), as tests/test_paged_kv.py: the
# value is in page bookkeeping and identity, not the matmuls
TINY = dict(max_position_embeddings=128, num_hidden_layers=1,
            hidden_size=32, intermediate_size=64, num_attention_heads=2)
VARIANTS = {"mha": {}, "gqa": {"num_key_value_heads": 1}}


def _ref_model(variant: str, seed: int = 0):
    """A reference tiny Llama with numpy weights from ``seed``, built
    with its initializers stubbed to zeros (their jitted random draws
    would compile for seconds)."""
    def zeros(self, shape, dtype):
        return jnp.zeros(shape, dtype)
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jax_init.XavierNormal, jax_init.XavierUniform,
                    jax_init.Normal, jax_init.Constant, jax_init.Uniform):
            mp.setattr(cls, "__call__", zeros)
        model = jax_llama.LlamaForCausalLM(
            jax_llama.llama_tiny_config(**TINY, **VARIANTS[variant]))
    rng = np.random.RandomState(seed)
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        t._data = jnp.asarray(
            np.ones(shape, np.float32) if name.endswith("norm.weight")
            else rng.normal(0, 0.3, shape).astype(np.float32))
    model.eval()
    return model


@pytest.fixture(scope="module")
def models():
    """variant -> (reference model, port model) sharing weights."""
    out = {}
    for variant, kw in VARIANTS.items():
        ref = _ref_model(variant)
        state = {n: np.asarray(t._data) for n, t in ref.state_dict().items()}
        out[variant] = (ref, llama_from_jax_state(
            state, port_llama.llama_tiny_config(**TINY, **kw),
            device="cpu"))
    return out


def _prompts(rng, lens, vocab=128):
    return [rng.randint(1, vocab, (n,)).astype(np.int64) for n in lens]


def _share_trio():
    rng = np.random.RandomState(3)
    A = rng.randint(1, 128, (16,)).astype(np.int64)
    B = np.concatenate([A, [5]])        # diverges AT a page boundary
    C = np.concatenate([A[:12], [9]])   # diverges mid-page (pos 12)
    return A, B, C


def _quiesced_ok(eng):
    v = page_leak_violations(eng)
    assert v == [], "\n".join(v)


# -- the attend and the quantizer against the jitted reference ---------

_jax_quantize = jax.jit(jax_dc.quantize_kv_page)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_page_bit_for_bit(dtype):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        rng.standard_normal((3, 8, 2, 16)).astype(np.float32) * 3)
    x[1, 2, 1] = 0.0                    # a never-written row: scale floor
    x = x.to(getattr(torch, dtype))
    q, s = quantize_kv_page(x)
    jq, js = _jax_quantize(jnp.asarray(x.float().numpy()).astype(dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


_jax_paged_attend = jax.jit(jax_dc.paged_cache_attend,
                            static_argnames=("out_dtype",))

# name -> (b, t real tokens, t with padding, heads, kv heads, positions
# (a list per row, or a scalar start), int8); page 8, 3 pages a row
ATTEND_CASES = {
    "decode_gqa": (3, 1, 1, 4, 2, [5, 13, 0], False),
    # real positions 10..13, padding 14..25: page 0 and past the table
    "extend_int8": (1, 4, 16, 2, 2, 10, True),
}


@pytest.mark.parametrize("case", sorted(ATTEND_CASES))
def test_paged_cache_attend_matches_reference(case):
    b, n_real, t, h, kv, p, quant = ATTEND_CASES[case]
    page, npg, num_pages, D = 8, 3, 10, 8
    rng = np.random.RandomState(len(case))
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
    if isinstance(p, list):
        table[-1] = 0                   # the inactive row: trash page 0
    else:
        table[0, -1] = 0                # a page not allocated yet
    arrays = (qr, kr, v, kp, vp, ks, vs)
    want = _jax_paged_attend(
        *(None if a is None else jnp.asarray(a) for a in arrays),
        jnp.asarray(table), jnp.asarray(p, jnp.int32),
        out_dtype=jnp.float32)
    pos = torch.as_tensor(p) if isinstance(p, list) else p
    got = paged_cache_attend(
        *(None if a is None else torch.from_numpy(a.copy())
          for a in arrays), torch.from_numpy(table), pos, torch.float32)
    np.testing.assert_allclose(got[0].numpy()[:, :n_real],
                               np.asarray(want[0])[:, :n_real],
                               atol=1e-6, rtol=1e-6)
    for g, w, name in zip(got[1:], want[1:], ("kp", "vp", "ks", "vs")):
        if g is None:
            assert w is None
            continue
        # page 0 is the trash page: several writes may land on one of
        # its slots in either order, and nothing reads it
        np.testing.assert_array_equal(
            g.numpy()[1:].view(np.uint8), np.asarray(w)[1:].view(np.uint8),
            err_msg=name)


# -- the paged engine against the reference's ---------------------------

def _trace():
    """A ragged burst with a same-wave shared prefix (the second shares
    the first's full page once it has prefilled), then the share trio,
    one request at a time."""
    rng = np.random.RandomState(1)
    burst = _prompts(rng, [12, 13, 16, 16, 15, 14])
    burst[1] = np.concatenate([burst[0][:10], burst[1][:3]])
    return [(p, 3) for p in burst], _share_trio()


def _serve(engine_cls, model, kv_dtype):
    """Serve ``_trace()`` in a pool of 8 usable pages (3 slots of up to
    3 pages: cached pages are reclaimed)."""
    eng = engine_cls(model, max_slots=3, max_len=64, min_bucket=16,
                     page_size=8, num_pages=9, kv_dtype=kv_dtype)
    burst, trio = _trace()
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in burst]
    eng.run()
    outs = [r.output_ids for r in reqs]
    for p in trio:
        r = eng.submit(p, max_new_tokens=4)
        eng.run()
        outs.append(r.output_ids)
    return outs, eng


COUNTERS = ("prefix_hit_tokens", "prefix_lookup_tokens", "cow_copies",
            "pages_reclaimed")
ENGINE_CASES = [("mha", None), ("gqa", "int8")]


@pytest.fixture(scope="module")
def reference_runs(models):
    """The reference's paged engines (two) on ``_trace()``:
    (variant, kv_dtype) -> (tokens, counters, cached pages)."""
    out = {}
    for variant, kv_dtype in ENGINE_CASES:
        outs, eng = _serve(JaxServingEngine, models[variant][0], kv_dtype)
        stats = eng.paged_stats()
        out[variant, kv_dtype] = (outs, {k: stats[k] for k in COUNTERS},
                                  eng.cache.cached_page_count())
    return out


@pytest.mark.parametrize("variant,kv_dtype", ENGINE_CASES)
def test_paged_engine_matches_reference(models, reference_runs, variant,
                                        kv_dtype):
    want_outs, want_stats, want_cached = reference_runs[variant, kv_dtype]
    outs, eng = _serve(ServingEngine, models[variant][1], kv_dtype)
    assert outs == want_outs
    stats = eng.paged_stats()
    assert {k: stats[k] for k in COUNTERS} == want_stats
    assert eng.cache.cached_page_count() == want_cached
    # the trace shares (same wave, page boundary, mid-page) and reclaims
    assert want_stats["cow_copies"] >= 1
    assert want_stats["pages_reclaimed"] >= 1
    assert stats["prefix_hit_tokens"] >= 8 + 16 + 12
    _quiesced_ok(eng)


# -- port-only laws (tests/test_paged_kv.py) ----------------------------

def _run_serial(model, prompts, share=True, quant=None, new=6,
                min_bucket=8):
    eng = ServingEngine(model, max_slots=3, max_len=64,
                        min_bucket=min_bucket, page_size=8,
                        prefix_sharing=share, kv_dtype=quant)
    out = []
    for p in prompts:
        r = eng.submit(p, max_new_tokens=new)
        eng.run()                       # serial: earlier prompts register
        out.append(r.output_ids)
    return out, eng


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_matches_contiguous_without_sharing(models, variant):
    """The non-shared paged path gives the contiguous pool's tokens (the
    same full-prefill route and the same decode einsum)."""
    model = models[variant][1]
    prompts = _prompts(np.random.RandomState(1), [3, 9, 5, 12, 7, 17])
    outs = []
    for kw in (dict(kv_layout="contiguous"),
               dict(page_size=8, prefix_sharing=False)):
        eng = ServingEngine(model, max_slots=2, max_len=64, min_bucket=4,
                            **kw)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == outs[1]
    assert eng.paged and eng.cache.page_size == 8
    _quiesced_ok(eng)


def test_sharing_matches_no_sharing_and_counts(models):
    model = models["mha"][1]
    ref, _ = _run_serial(model, _share_trio(), share=False)
    got, eng = _run_serial(model, _share_trio())
    assert got == ref
    s = eng.paged_stats()
    # B matches A's two full pages (16), C page 0 and 4 tokens of page 1
    assert s["prefix_hit_tokens"] == 28 and s["cow_copies"] == 1, s
    assert s["prefix_hit_rate"] == 28 / (15 + 16 + 12)
    _quiesced_ok(eng)


def test_geometry_and_argument_validation(models):
    dev = torch.device("cpu")
    for bad in [dict(num_layers=0), dict(max_slots=0), dict(max_len=0),
                dict(kv_heads=0), dict(head_dim=0)]:
        kw = dict(num_layers=2, max_slots=2, max_len=16, kv_heads=2,
                  head_dim=4)
        kw.update(bad)
        with pytest.raises(ValueError):
            PagedKVCache(*kw.values(), torch.float32, dev, page_size=8)
    with pytest.raises(ValueError, match="multiple of page_size"):
        PagedKVCache(1, 2, 20, 2, 4, torch.float32, dev, page_size=8)
    with pytest.raises(ValueError, match="page_size"):
        PagedKVCache(1, 2, 16, 2, 4, torch.float32, dev, page_size=0)
    with pytest.raises(ValueError, match="num_pages"):
        PagedKVCache(1, 2, 16, 2, 4, torch.float32, dev, page_size=8,
                     num_pages=2)
    contiguous = ServingEngine(models["mha"][1], kv_layout="contiguous",
                               max_slots=2, max_len=16).cache
    assert contiguous.kv_bytes() == 2 * 2 * 16 * 2 * 16 * 4
    model = models["mha"][1]
    with pytest.raises(ValueError, match="kv_dtype"):
        ServingEngine(model, kv_dtype="int4")
    with pytest.raises(ValueError, match="paged kv_layout"):
        ServingEngine(model, kv_layout="contiguous", page_size=8)
    eng = ServingEngine(model, max_len=96)
    assert eng.paged and eng.page_size == 32 and eng.prefix_sharing
    assert eng.cache.num_pages == 8 * 3 + 1     # capacity parity
    with pytest.raises(RuntimeError):
        ServingEngine(model, kv_layout="contiguous").paged_stats()


def test_page_span_and_reservation_accounting():
    c = PagedKVCache(1, 2, 32, 2, 4, torch.float32, torch.device("cpu"),
                     page_size=8, num_pages=5, prefix_sharing=False)
    reqs = [Request(rid=i, prompt=np.arange(1, 10), max_new_tokens=8,
                    sampling=SamplingParams()) for i in range(4)]
    assert [c.page_span(n) for n in (2, 9, 10, 32)] == [1, 1, 2, 4]
    assert c.usable_pages() == 4        # trash page excluded
    ids = np.arange(1, 10)
    assert c.try_reserve(reqs[0], ids, 17)
    assert c.committed_pages == 2
    assert c.try_reserve(reqs[1], ids, 17)
    assert not c.try_reserve(reqs[2], ids, 17)
    assert not c.try_reserve(reqs[3], ids, 32)
    assert c.begin_sequence(0, reqs[0], ids) == (0, [])
    assert c.free_page_count() == 2
    c.assign(0, reqs[0])
    c.release(0)
    assert c.free_page_count() == 4 and c.committed_pages == 2
    assert (c.page_table[0] == 0).all()
    c.cancel_reservation(reqs[1])
    assert c.committed_pages == 0 and not c._plans


def test_shared_pages_are_refcounted_and_cached_after_release(models):
    A, B, _ = _share_trio()
    eng = ServingEngine(models["mha"][1], max_slots=2, max_len=64,
                        min_bucket=8, page_size=8)
    eng.submit(A, max_new_tokens=4)
    eng.run()
    cache = eng.cache
    assert cache.cached_page_count() == 2   # A's two full prompt pages
    rb = eng.submit(B, max_new_tokens=4)
    eng.step()                              # B references A's pages
    shared = [int(p) for p in cache.page_table[rb.slot][:2]]
    assert all(cache.refcnt[p] == 1 for p in shared)
    assert cache.cached_page_count() == 0
    eng.run()
    assert all(cache.refcnt[p] == 0 for p in shared)
    assert cache.cached_page_count() >= 2
    _quiesced_ok(eng)


def test_refcounts_release_on_deadline_cancel_and_drain(models):
    clock = {"t": 0.0}
    prompts = _prompts(np.random.RandomState(4), [9, 9, 9, 9])
    eng = ServingEngine(models["mha"][1], max_slots=2, max_len=64,
                        min_bucket=8, page_size=8,
                        time_fn=lambda: clock["t"])
    r0 = eng.submit(prompts[0], max_new_tokens=30, deadline_s=2.0)
    r1 = eng.submit(prompts[1], max_new_tokens=30)
    r2 = eng.submit(prompts[2], max_new_tokens=30)       # queued
    eng.step()
    assert eng.cache.active_page_count() > 0
    clock["t"] = 5.0                    # r0 expires at the next sweep
    eng.step()
    assert r0.finished and r0.finish_reason == "deadline"
    assert eng.cancel(r1) and r1.finish_reason == "cancelled"
    assert not eng.cancel(r1)
    assert eng.cancel(r2) and r2.slot is None
    r3 = eng.submit(prompts[3], max_new_tokens=30)
    eng.step()
    done = eng.drain(max_steps=1)
    assert r3 in done and r3.finish_reason == "cancelled"
    assert eng.cache.active_slots() == []
    _quiesced_ok(eng)


def test_failed_prefill_returns_its_pages(models):
    """A shared-prefix prefill whose model call raises after its pages
    were claimed (and a COW copy made) returns every page and its
    counters; the broken engine's drain cancels the rest."""
    A, _, C = _share_trio()
    eng = ServingEngine(models["mha"][1], max_slots=2, max_len=64,
                        min_bucket=8, page_size=8)
    eng.submit(A, max_new_tokens=2)
    eng.run()
    hits, cow = eng.cache.prefix_hit_tokens, eng.cache.cow_copies

    def boom(ids, caches):
        raise RuntimeError("device fault")
    eng.adapter.call = boom
    rc = eng.submit(C, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="device fault"):
        eng.step()
    assert eng.cache.cow_copies == cow + 1         # the claim got that far
    assert eng.cache.active_page_count() == 0
    assert eng.cache.committed_pages == 0
    assert eng.cache.prefix_hit_tokens == hits     # rolled back
    with pytest.raises(EngineBroken):
        eng.step()
    assert eng.drain() == [rc] and rc.finish_reason == "cancelled"
    _quiesced_ok(eng)


def test_admission_gated_by_free_pages_not_slots(models):
    model = models["mha"][1]
    prompts = _prompts(np.random.RandomState(7), [9] * 6)
    # span(9 + 6) = 2 pages a request; 4 usable pages -> 2 in flight
    eng = ServingEngine(model, max_slots=6, max_len=32, min_bucket=8,
                        page_size=8, num_pages=5, prefix_sharing=False)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    peak = 0
    while eng.has_work():
        eng.step()
        peak = max(peak, len(eng.cache.active_slots()))
    assert peak == 2 == eng.paged_stats()["peak_active_slots"]
    assert all(r.finish_reason == "length" for r in reqs)
    ref = ServingEngine(model, max_slots=6, max_len=32, min_bucket=8,
                        kv_layout="contiguous")
    rr = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ref.run()
    assert [r.output_ids for r in reqs] == [r.output_ids for r in rr]
    _quiesced_ok(eng)


def test_cached_prefix_pages_are_reclaimed_under_pressure(models):
    rng = np.random.RandomState(9)
    eng = ServingEngine(models["mha"][1], max_slots=2, max_len=32,
                        min_bucket=8, page_size=8, num_pages=6)
    eng.submit(rng.randint(1, 128, (17,)), max_new_tokens=2)
    eng.run()
    assert eng.cache.cached_page_count() == 2
    for _ in range(2):                  # disjoint prompts needing pages
        r = eng.submit(rng.randint(1, 128, (17,)), max_new_tokens=4)
        eng.run()
        assert r.finish_reason == "length"
    assert eng.cache.pages_reclaimed > 0
    _quiesced_ok(eng)


def test_prefix_hit_counters_count_commits_not_retries(models):
    prompts = _prompts(np.random.RandomState(12), [9, 9, 9])
    # the pool fits two 2-page requests at a time: the third blocks
    eng = ServingEngine(models["mha"][1], max_slots=3, max_len=32,
                        min_bucket=8, page_size=8, num_pages=5)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    eng.run()
    assert eng.cache.prefix_lookup_tokens == 24
    _quiesced_ok(eng)


def test_extend_bucket_overrunning_rope_table_stays_identical(models):
    """The shared tail's bucket padding runs past the rope table (start
    56 + bucket 16 > 64): the real tail still rotates at its true
    positions."""
    ref, _ = models["mha"]
    state = {n: np.asarray(t._data) for n, t in ref.state_dict().items()}
    cfg = port_llama.llama_tiny_config(**dict(
        TINY, max_position_embeddings=64))
    model = llama_from_jax_state(state, cfg, device="cpu")
    rng = np.random.RandomState(11)
    A = rng.randint(1, 128, (60,)).astype(np.int64)
    B = np.concatenate([A[:59], [7]])   # matched 56, tail 4 -> bucket 16
    outs = [_run_serial(model, (A, B), share=share, new=4, min_bucket=16)
            for share in (False, True)]
    assert outs[1][1].cache.prefix_hit_tokens == 56
    assert outs[0][0] == outs[1][0]


def test_int8_pools_and_greedy_parity_gate(models):
    """int8 KV: int8 pools with f32 scales, greedy agreement with the
    model-dtype path >= 0.9 (the reference's measured-parity gate)."""
    model = models["gqa"][1]
    prompts = _prompts(np.random.RandomState(5), [5, 11, 8, 14])
    ref, _ = _run_serial(model, prompts, share=False)
    got, eng = _run_serial(model, prompts, share=False, quant="int8")
    pairs = [(a, b) for x, y in zip(got, ref) for a, b in zip(x, y)]
    assert sum(a == b for a, b in pairs) / len(pairs) >= 0.9
    assert eng.kv_quant and eng.cache.quant
    assert eng.cache.ks[0].dtype == torch.int8
    assert eng.cache.kss[0].dtype == torch.float32
    assert eng.cache.kv_bytes() == sum(
        p.numel() * p.element_size()
        for p in eng.cache.ks + eng.cache.vs + eng.cache.kss
        + eng.cache.vss)
    _quiesced_ok(eng)


def test_claim_raising_mid_batch_unwinds_the_batch():
    s = FIFOScheduler()
    reqs = [Request(rid=i, prompt=np.zeros(2, np.int64), max_new_tokens=1,
                    sampling=SamplingParams()) for i in range(3)]
    for r in reqs:
        s.add(r)
    claimed, unclaimed = [], []

    def claim(req):
        if req.rid == 1:
            raise RuntimeError("claim fault")
        claimed.append(req.rid)
        return True
    with pytest.raises(RuntimeError, match="claim fault"):
        s.admissions([0, 1, 2], claim=claim,
                     unclaim=lambda r: unclaimed.append(r.rid))
    assert claimed == unclaimed == [0] and s.depth == 3
    got = s.admissions([0, 1], claim=lambda r: r.rid == 0)
    assert [(slot, r.rid) for slot, r in got] == [(0, 0)]
    assert s.depth == 2                 # a refused head blocks the rest
