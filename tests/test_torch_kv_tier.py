"""paddle_tpu_torch's KV host tier (serving/kv_tier.py, the tier half of
PagedKVCache and the engine's kv_host_tier / host_tier_pages /
prefix_store_dir) against the reference's (paddle_tpu/serving, JAX on
the CPU), mirroring tests/test_cache_tiering.py.

The model is the reference tests' one-layer tiny Llama (width 32, 128
positions) drawn by the reference's initializers from seed 0 and carried
across by models/convert.py; f32 on one torch thread. Two reference
engines are built: a tiered f32 engine on the identity band's waves and
a tiered int8 engine on the pressured A/B/C trace. Tokens and counters
are held exactly (tolerance 0). The HostPageTier and the store run the
same operation sequences as the reference's, on numpy payloads there
and torch payloads here, and must give the same answers.

The port writes its pools in place, so a failed step breaks the engine
(the reference's donated-pool path); a reference fault test maps to
"broken, the state at the raise asserted, ``recover()``, then the same
tokens".
"""
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models.convert import llama_from_jax_state
from paddle_tpu_torch.resilience import faults, page_leak_violations
from paddle_tpu_torch.resilience.invariants import engine_leak_violations
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.kv_tier import (HostPageTier,
                                              PersistentPrefixStore)

KW = dict(max_position_embeddings=128, num_hidden_layers=1,
          hidden_size=32, intermediate_size=64, num_attention_heads=2)
PRESSURED = dict(max_slots=1, max_len=32, min_bucket=8, page_size=8,
                 num_pages=5)
BAND = dict(max_slots=2, max_len=64, min_bucket=8, page_size=8,
            num_pages=10)


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
    """(reference model, port f32 model, port bf16 model)."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny_config
    paddle.seed(0)
    ref = LlamaForCausalLM(llama_tiny_config(**KW))
    ref.eval()
    state = {n: np.asarray(t._data) for n, t in ref.state_dict().items()}
    cfg = port_llama.llama_tiny_config(**KW)
    return (ref, llama_from_jax_state(state, cfg, device="cpu"),
            llama_from_jax_state(state, cfg, device="cpu",
                                 dtype="bfloat16"))


def _quiesced_ok(eng):
    v = page_leak_violations(eng) + engine_leak_violations(eng)
    assert v == [], "\n".join(v)


def _np_payload(L=1, P=8, H=2, D=4, fill=0.0, quant=False):
    sc = (L, P, H) if quant else (0,)
    dt = np.int8 if quant else np.float32
    return {"k": np.full((L, P, H, D), fill, dt),
            "v": np.full((L, P, H, D), fill, dt),
            "ks": np.ones(sc, np.float32), "vs": np.ones(sc, np.float32)}


def _payload(**kw):
    return {f: torch.from_numpy(a) for f, a in _np_payload(**kw).items()}


def _pressured_trace():
    rng = np.random.RandomState(21)
    A = rng.randint(1, 128, (17,)).astype(np.int64)
    B = rng.randint(1, 128, (17,)).astype(np.int64)
    C = np.concatenate([A[:16], [5, 9]]).astype(np.int64)
    return A, B, C


def _serial(eng, prompts, new=2):
    out = []
    for p in prompts:
        r = eng.submit(p, max_new_tokens=new)
        eng.run()
        out.append(r.output_ids)
    return out


TIER_FIELDS = ("pages_host", "demotions", "promotions",
               "prefix_hit_tokens_host", "prefix_hit_tokens_disk",
               "prefix_hit_tokens", "prefix_lookup_tokens", "pages_free",
               "pages_cached", "cow_copies", "pages_reclaimed")


# -- knob / geometry validation -----------------------------------------

def test_tier_knob_validation(models, tmp_path):
    """The reference's refusals (a tier needs the paged layout with
    prefix sharing; host_tier_pages needs a tier; capacity >= 1), the
    mesh combination still refused (the mesh is a later slice), and a
    prefix_store_dir alone turning the tier on."""
    m = models[1]
    with pytest.raises(ValueError, match="host_tier_pages"):
        ServingEngine(m, max_slots=2, max_len=64, min_bucket=8,
                      page_size=8, host_tier_pages=4)
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(m, max_slots=2, max_len=64, min_bucket=8,
                      kv_layout="contiguous", kv_host_tier=True)
    with pytest.raises(ValueError, match="prefix_sharing"):
        ServingEngine(m, max_slots=2, max_len=64, min_bucket=8,
                      page_size=8, prefix_sharing=False,
                      kv_host_tier=True)
    with pytest.raises(ValueError, match="capacity_pages"):
        HostPageTier(1, 8, 2, 4, torch.float32, capacity_pages=0)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ServingEngine(m, max_slots=2, max_len=64, min_bucket=8,
                      page_size=8, kv_host_tier=True, mesh=object())
    eng = ServingEngine(m, max_slots=2, max_len=64, min_bucket=8,
                        page_size=8, prefix_store_dir=str(tmp_path))
    assert eng.kv_host_tier and eng.cache.tier is eng._kv_tier
    assert eng._kv_tier.store is not None
    assert eng._kv_tier.pin_payloads is False     # CPU pools


# -- HostPageTier: LRU, pinning, geometry --------------------------------

def _tier_script(tier_cls, payload, dtype):
    """The reference test's operation sequence; returns what each step
    answered."""
    evicted = []
    tier = tier_cls(1, 8, 2, 4, dtype, capacity_pages=2,
                    on_evict=evicted.append)
    a = tuple(range(8))
    b = a + tuple(range(10, 18))        # descendant chunk of a
    c = tuple(range(100, 108))
    d = tuple(range(200, 208))
    out = [tier.put(a, payload()), tier.put(b, payload()),
           tier.put(c, payload()), list(evicted),
           [tier.where(k) for k in (a, b, c)]]
    tier.pin(b)
    out += [tier.put(d, payload()), [tier.where(k) for k in (b, c, d)]]
    out += [tier.put(a, payload()), tier.where(d),
            tier.put(tuple(range(300, 308)), payload()),
            tier.host_page_count(), tier.stats()]
    tier.unpin(b)
    with pytest.raises(RuntimeError, match="underflow"):
        tier.unpin(b)
    with pytest.raises(ValueError, match="geometry"):
        tier.put(tuple(range(8)), payload(P=4))
    return out


def test_host_tier_lru_eviction_and_pin_blocking():
    """The same sequence through the reference's tier and the port's:
    LRU eviction, a pinned key unevictable, its ancestors blocked, a put
    refused when nothing is evictable, the pin underflow and geometry
    refusals; every answer equal."""
    from paddle_tpu.serving.kv_tier import HostPageTier as JaxTier
    want = _tier_script(JaxTier, _np_payload, np.float32)
    got = _tier_script(HostPageTier, _payload, torch.float32)
    assert got == want
    assert got[3] == [tuple(range(8))]        # LRU (a) evicted
    assert got[-3] is False and got[-2] == 2  # refused at capacity


# -- PersistentPrefixStore: atomicity, torn writes, geometry guard ------

def test_store_round_trip_torn_write_and_geometry_guard(tmp_path):
    """Atomic puts leave no temp file; a torn chunk reads as absent and
    is unlinked; a scan drops a truncated one; another geometry drops
    every entry. File names follow the reference's rule, and a bf16
    payload comes back bit for bit, with ``"bfloat16"`` in meta.json."""
    import json
    from paddle_tpu.serving import kv_tier as jax_tier
    geo = dict(num_layers=1, page_size=8, kv_heads=2, head_dim=4,
               dtype=torch.float32, quant=False)
    store = PersistentPrefixStore(str(tmp_path / "f32"), **geo)
    k1, k2 = tuple(range(8)), tuple(range(50, 58))
    store.put(k1, _payload(fill=3.5))
    got = store.get(k1)
    assert torch.equal(got["k"], torch.full((1, 8, 2, 4), 3.5))
    assert os.path.basename(store._file(k1)) == jax_tier._key_file(k1)
    assert not [n for n in os.listdir(store.path) if n.endswith(".tmp")]
    store.put(k2, _payload())
    with open(store._file(k2), "wb") as f:
        f.write(b"\x00garbage")
    assert store.get(k2) is None
    assert not os.path.exists(store._file(k2))
    store.put(k2, _payload())
    with open(store._file(k2), "r+b") as f:
        f.truncate(10)
    assert store.keys() == [k1]
    other = PersistentPrefixStore(store.path, **{**geo, "head_dim": 8})
    assert not other.has(k1) and other.keys() == []
    # bf16: raw 16 bits on disk, the same bits back, the dtype recorded
    bstore = PersistentPrefixStore(str(tmp_path / "bf16"),
                                   **{**geo, "dtype": torch.bfloat16})
    g = torch.Generator().manual_seed(3)
    pay = {"k": torch.randn((1, 8, 2, 4), generator=g).bfloat16(),
           "v": torch.randn((1, 8, 2, 4), generator=g).bfloat16(),
           "ks": torch.zeros((0,)), "vs": torch.zeros((0,))}
    bstore.put(k1, pay)
    back = bstore.get(k1)
    for f in ("k", "v"):
        assert back[f].dtype == torch.bfloat16
        assert torch.equal(back[f].view(torch.int16),
                           pay[f].view(torch.int16))
    with open(os.path.join(bstore.path, "meta.json")) as f:
        assert json.load(f)["dtype"] == "bfloat16"
    # int8 pools: codes and f32 scales
    qstore = PersistentPrefixStore(str(tmp_path / "q"),
                                   **{**geo, "quant": True})
    qpay = _payload(fill=-7, quant=True)
    qstore.put(k1, qpay)
    assert all(torch.equal(qstore.get(k1)[f], qpay[f]) for f in qpay)


# -- deterministic demote -> promote round trip --------------------------

def _demoted_bits(eng):
    """Record a clone of every payload the tier takes."""
    seen = {}
    put = eng._kv_tier.put

    def spy(key, payload):
        seen[tuple(key)] = {f: t.clone() for f, t in payload.items()}
        return put(key, payload)
    eng._kv_tier.put = spy
    return seen


def _page_of(cache, key):
    node = cache._root
    for j in range(0, len(key), cache.page_size):
        node = node.children[tuple(key[j:j + cache.page_size])]
    return node.page


@pytest.fixture(scope="module")
def ref_int8(models):
    """The reference tiered int8 engine's tokens and counters on the
    pressured A, B, C trace."""
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    eng = JaxServingEngine(models[0], kv_host_tier=True, kv_dtype="int8",
                           **PRESSURED)
    outs = _serial(eng, _pressured_trace())
    return outs, eng.paged_stats()


@pytest.mark.parametrize("precision", ["f32", "int8", "bf16"])
def test_demote_promote_round_trip(models, ref_int8, precision):
    """A caches two full prompt pages, the disjoint B's allocation
    DEMOTES A's first page, and C (A's first two pages, then a new
    tail) promotes it back into a fresh device page before its extend:
    the page holds the demoted bits exactly. int8: tokens and counters
    equal the reference's tiered int8 engine; f32: tokens equal the
    untiered engine's and counters the reference's (they do not depend
    on the pool's dtype); bf16: the bits, and tokens the untiered bf16
    engine's."""
    model = models[2] if precision == "bf16" else models[1]
    kw = {"kv_dtype": "int8"} if precision == "int8" else {}
    A, B, C = _pressured_trace()
    eng = ServingEngine(model, kv_host_tier=True, **PRESSURED, **kw)
    seen = _demoted_bits(eng)
    outs = _serial(eng, (A, B))
    st = eng.paged_stats()
    assert st["demotions"] >= 1 and st["pages_host"] >= 1, st
    key = tuple(int(t) for t in A[:8])
    payload = seen[key]
    outs += _serial(eng, (C,))
    st = eng.paged_stats()
    assert st["promotions"] >= 1 and st["prefix_hit_tokens_host"] >= 8, st
    c = eng.cache
    page = _page_of(c, key)
    assert page > 0
    for f, pools in (("k", c.ks), ("v", c.vs), ("ks", c.kss),
                     ("vs", c.vss)):
        for i, pool in enumerate(pools):
            assert torch.equal(pool[page], payload[f][i]), (f, i)
    want_outs, want_st = ref_int8
    assert {k: st[k] for k in TIER_FIELDS} \
        == {k: want_st[k] for k in TIER_FIELDS}
    if precision == "int8":
        assert outs == want_outs
    else:
        plain = ServingEngine(model, **PRESSURED, **kw)
        assert outs == _serial(plain, (A, B, C))
    _quiesced_ok(eng)


# -- the identity band ----------------------------------------------------

BAND_SEEDS = list(range(25))
_band_done = {"n": 0}


@pytest.fixture(scope="module")
def band(models):
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    rng = np.random.RandomState(20)
    sysA = rng.randint(1, 128, (24,)).astype(np.int64)
    sysB = rng.randint(1, 128, (24,)).astype(np.int64)
    return {"sys": (sysA, sysB),
            "ref": JaxServingEngine(models[0], kv_host_tier=True, **BAND),
            "tiered": ServingEngine(models[1], kv_host_tier=True, **BAND),
            "untiered": ServingEngine(models[1], **BAND)}


@pytest.mark.parametrize("seed", BAND_SEEDS)
def test_tiered_identity_band(band, seed):
    """Each seed is one wave of two requests on that wave's system
    prompt; waves alternate between two prompts, so under the 9-page
    budget each flip demotes the other prompt's pages and the flip back
    promotes them. The port's tiered engine gives the reference tiered
    engine's tokens and tier counters after every wave, and the port's
    untiered engine the same tokens."""
    rng = np.random.RandomState(5000 + seed)
    sysp = band["sys"][seed % 2]
    prompts = [np.concatenate([sysp, rng.randint(1, 128, (6,))])
               .astype(np.int64) for _ in range(2)]
    outs = {}
    for name in ("ref", "tiered", "untiered"):
        eng = band[name]
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        outs[name] = [r.output_ids for r in reqs]
    assert outs["tiered"] == outs["ref"]
    assert outs["untiered"] == outs["ref"]
    got, want = band["tiered"].paged_stats(), band["ref"].paged_stats()
    assert {k: got[k] for k in TIER_FIELDS} \
        == {k: want[k] for k in TIER_FIELDS}
    _band_done["n"] += 1


def test_identity_band_really_tiered(band):
    """Not green by vacuity: the band really demoted and promoted, the
    untiered engine never demoted, and both quiesce leak-free across
    both tiers."""
    if _band_done["n"] < len(BAND_SEEDS):
        pytest.skip("full identity band did not run")
    st = band["tiered"].paged_stats()
    assert st["demotions"] >= 5, st
    assert st["promotions"] >= 5, st
    assert st["prefix_hit_tokens_host"] >= 5 * 8, st
    assert band["untiered"].paged_stats()["demotions"] == 0
    s = band["tiered"].metrics.summary()
    assert s["promotion_wait_p99_s"] >= 0.0
    _quiesced_ok(band["tiered"])
    _quiesced_ok(band["untiered"])


# -- persistence: restart + recover warm starts --------------------------

def _sys_and_tails():
    rng = np.random.RandomState(22)
    sysA = rng.randint(1, 128, (24,)).astype(np.int64)
    sysB = rng.randint(1, 128, (24,)).astype(np.int64)
    tails = [rng.randint(1, 128, (6,)).astype(np.int64) for _ in range(6)]
    return sysA, sysB, tails


def test_persistent_store_survives_restart(models, tmp_path):
    """A fresh engine over the same store directory rehydrates the
    radix index from disk and serves its FIRST wave with disk prefix
    hits, token-identical to a cold untiered engine."""
    model = models[1]
    sysA, sysB, tails = _sys_and_tails()
    eng = ServingEngine(model, prefix_store_dir=str(tmp_path), **BAND)
    for wave in range(4):
        sysp = (sysA, sysB)[wave % 2]
        for t in tails[:2]:
            eng.submit(np.concatenate([sysp, t]), max_new_tokens=8)
        eng.run()
    assert eng.paged_stats()["demotions"] >= 1
    _quiesced_ok(eng)
    restarted = ServingEngine(model, prefix_store_dir=str(tmp_path), **BAND)
    cold = ServingEngine(model, **BAND)
    wave = [np.concatenate([sysA, t]).astype(np.int64) for t in tails[4:6]]
    outs = []
    for e in (restarted, cold):
        reqs = [e.submit(p, max_new_tokens=8) for p in wave]
        e.run()
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == outs[1]
    st = restarted.paged_stats()
    assert st["prefix_hit_tokens_disk"] > 0, st
    assert st["promotions"] >= 1 and st["prefix_hit_rate"] > 0, st
    _quiesced_ok(restarted)


def test_recover_rehydrates_from_host_tier(models):
    """The tier OUTLIVES the cache: ``recover()`` builds fresh host
    state but rebinds the surviving tier, so demoted chunks are matched
    and promoted right after recovery."""
    A, B, C = _pressured_trace()
    eng = ServingEngine(models[1], kv_host_tier=True, **PRESSURED)
    _serial(eng, (A, B))
    assert eng.cache.tier.host_page_count() >= 1
    eng.recover()
    r = eng.submit(C, max_new_tokens=2)
    eng.run()
    st = eng.paged_stats()
    assert st["promotions"] >= 1 and st["prefix_hit_tokens_host"] >= 8, st
    assert r.finish_reason == "length"
    _quiesced_ok(eng)


def test_decode_fault_mid_wave_recovers_tiered_tokens(models):
    """Port-only law: a decode fault mid-wave on a tiered engine whose
    in-flight requests were admitted through promotions; ``recover()``
    writes their prompts again by the same route (the rebuilt index
    holds the tier's host nodes, so they promote again) and the wave
    gives the fault-free tokens with zero replay mismatches and no
    leak."""
    sysA, sysB, tails = _sys_and_tails()

    def run(fault):
        eng = ServingEngine(models[1], kv_host_tier=True, **BAND)
        for sysp in (sysA, sysB):          # A demoted under B's pages
            for t in tails[:2]:
                eng.submit(np.concatenate([sysp, t]), max_new_tokens=8)
            eng.run()
        reqs = [eng.submit(np.concatenate([sysA, t]), max_new_tokens=8)
                for t in tails[2:4]]
        promoted = eng.cache.promotions
        if fault:
            faults.inject("serving.step.decode", times=1, after=3)
        report = None
        while eng.has_work():
            try:
                eng.step()
            except faults.InjectedFault:
                assert eng.cache.promotions > promoted
                report = eng.recover()
        return eng, [r.output_ids for r in reqs], report
    base, want, _ = run(False)
    eng, got, report = run(True)
    assert faults.fired("serving.step.decode") == 1
    assert got == want
    assert report["replay_mismatches"] == 0
    assert report["recovered_slots"] == 2
    assert report["reroutes"] == 0
    # the rebuilt cache promoted the system prompt again
    assert eng.paged_stats()["promotions"] >= 1
    _quiesced_ok(eng)
    _quiesced_ok(base)


# -- fault unwinds on both tier points -----------------------------------

def test_demote_fault_unwinds_leak_free(models):
    """``serving.kv.demote`` fires BEFORE either tier mutates: the
    reclaim aborts and the admission unwinds (the request requeued, its
    reservation returned). ``recover()`` parks A's indexed pages in the
    tier (where the demotion would have put them), so the retry finds
    free pages and the tier holds A's prefix."""
    A, B, _ = _pressured_trace()
    eng = ServingEngine(models[1], kv_host_tier=True, **PRESSURED)
    _serial(eng, (A,))
    faults.inject("serving.kv.demote", times=1)
    rb = eng.submit(B, max_new_tokens=2)    # its allocation reclaims
    with pytest.raises(faults.InjectedFault):
        eng.step()
    assert faults.fired("serving.kv.demote") == 1
    assert eng.cache.demotions == 0             # nothing mutated
    assert eng.cache.tier.host_page_count() == 0
    assert eng.cache.committed_pages == 0
    assert eng.scheduler.pending() == [rb]      # requeued, not lost
    assert page_leak_violations(eng) == []
    eng.recover()
    assert eng.cache.tier.host_page_count() == 2   # A's pages, parked
    eng.run()
    assert rb.finish_reason == "length"
    assert eng.cache.tier.has(tuple(int(t) for t in A[:8]))
    _quiesced_ok(eng)


def test_promote_fault_unwinds_leak_free(models):
    """``serving.kv.promote`` fires with the request STAGED and its dst
    pages claimed: the unwind pops the staging entry and returns every
    page and tier pin; after ``recover()`` the requeued retry promotes
    and gives the fault-free tokens."""
    A, B, C = _pressured_trace()
    ref_out = _serial(ServingEngine(models[1], **PRESSURED), (A, B, C))[2]
    eng = ServingEngine(models[1], kv_host_tier=True, **PRESSURED)
    _serial(eng, (A, B))
    faults.inject("serving.kv.promote", times=1)
    rc = eng.submit(C, max_new_tokens=2)
    with pytest.raises(faults.InjectedFault):
        eng.step()
    assert faults.fired("serving.kv.promote") == 1
    assert eng._staged_promotions == {}
    assert eng.cache.tier.pin_counts() == {}
    assert eng.cache.committed_pages == 0
    assert eng.cache.promotions == 0
    assert eng.scheduler.pending() == [rc]
    assert page_leak_violations(eng) == []
    eng.recover()
    eng.run()
    assert rc.output_ids == ref_out
    assert eng.cache.promotions >= 1
    _quiesced_ok(eng)


# -- cross-tier no-leak audit goes red -----------------------------------

def test_cross_tier_audit_catches_manufactured_leaks(models):
    """``page_leak_violations`` goes RED on each cross-tier class: a
    leaked promotion pin, a host buffer no radix node anchors, and a
    HOST node whose tier data vanished; the staged-promotion half of
    the engine law goes red on a staging entry left behind."""
    A, B, _ = _pressured_trace()
    eng = ServingEngine(models[1], kv_host_tier=True, **PRESSURED)
    _serial(eng, (A, B))
    _quiesced_ok(eng)
    tier = eng.cache.tier
    key = tier.ram_keys()[0]
    tier.pin(key)
    assert any("tier pins" in v for v in page_leak_violations(eng))
    tier.unpin(key)
    _quiesced_ok(eng)
    orphan = tuple(range(1000, 1008))
    tier.put(orphan, eng.cache._read_page_payload(0))
    assert any("orphaned host-tier" in v for v in page_leak_violations(eng))
    tier.drop(orphan)
    _quiesced_ok(eng)
    eng._staged_promotions[99] = 0
    assert any("staged KV promotions" in v
               for v in engine_leak_violations(eng))
    del eng._staged_promotions[99]
    tier.drop(key)                              # data gone, node stays
    assert any("dataless HOST" in v for v in page_leak_violations(eng))
