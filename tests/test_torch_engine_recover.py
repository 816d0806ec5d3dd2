"""paddle_tpu_torch's ServingEngine.recover(), adopt(), the fault points
and the step's observability, against the reference engine's tokens
(paddle_tpu/serving/engine.py, JAX on the CPU) and the laws of
tests/test_resilience.py, tests/test_serving_engine.py,
tests/test_paged_kv.py, tests/test_spec_decode.py and
tests/test_observability.py mirrored on the port.

The model is the reference tests' tiny Llama (llama_tiny_config, 128
positions) drawn by the reference's initializers from seed 0 and carried
across by models/convert.py; f32 on one torch thread. The uninjected
tokens come from two reference engines (contiguous and paged, each
compiled once, serving every scenario's prompts), and every injected run
must give them exactly, with ``replay_mismatches == 0``.

The port writes its KV pools in place, so every failed step breaks the
engine, as the reference's donated-pool path does (its tests set
``eng._donate = lambda: (5, 6)``); a reference test of its undonated CPU
flavour (a failed step simply retried) maps here to "broken,
``recover()``, then the same tokens". Every engine has a
``ConservationLedger`` as its auditor, and every scenario ends with an
empty ledger, engine-leak and page-leak audit.
"""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.observability import FlightRecorder, MetricRegistry
from paddle_tpu_torch.resilience import (ConservationLedger,
                                         engine_leak_violations,
                                         page_leak_violations)
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (EngineBroken, EngineClosed,
                                      RequestCancelled, ServingEngine)

KW = dict(max_position_embeddings=128)
LAYOUTS = ("contiguous", "paged")


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
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.models.convert import llama_from_jax_state
    paddle.seed(0)
    ref = LlamaForCausalLM(llama_tiny_config(**KW))
    ref.eval()
    state = {n: np.asarray(t._data) for n, t in ref.state_dict().items()}
    return ref, llama_from_jax_state(
        state, port_llama.llama_tiny_config(**KW), device="cpu")


def _layout_kw(layout):
    return dict(page_size=8) if layout == "paged" \
        else dict(kv_layout="contiguous")


@pytest.fixture(scope="module")
def reference(models):
    """layout -> (reference engine, its registry): the uninjected runs."""
    from paddle_tpu.observability import MetricRegistry as JaxRegistry
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    out = {}
    for layout in LAYOUTS:
        reg = JaxRegistry()
        out[layout] = (JaxServingEngine(
            models[0], max_slots=2, max_len=64, min_bucket=8, registry=reg,
            **_layout_kw(layout)), reg)
    return out


def _want(reference, layout, prompts, new):
    """The reference engine's greedy tokens for ``prompts``."""
    eng = reference[layout][0]
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    eng.run()
    return [r.output_ids for r in reqs]


def _engine(models, layout, led=None, **kw):
    kw.setdefault("max_slots", 2)
    return ServingEngine(models[1], max_len=64, min_bucket=8,
                         registry=MetricRegistry(),
                         flight_recorder=FlightRecorder(capacity=16),
                         auditor=led, **_layout_kw(layout), **kw)


def _audited(eng, led):
    v = engine_leak_violations(eng) + page_leak_violations(eng) \
        + led.violations()
    assert v == [], "\n".join(v)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).astype(np.int64) for n in lens]


def _serve_recovering(eng, reqs):
    """Step to the end, recovering after every injected fault; returns
    (every request delivered, recover reports)."""
    delivered, reports = [], []
    while eng.has_work():
        try:
            delivered.extend(eng.step())
        except faults.InjectedFault:
            with pytest.raises(EngineBroken, match="recover"):
                eng.step()
            with pytest.raises(EngineBroken):
                eng.submit(np.arange(1, 4), 2)
            rep = eng.recover()
            delivered.extend(rep["finished"])
            reports.append(rep)
    return delivered, reports


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_fault_recover_finishes_token_identical(models, reference,
                                                       layout):
    """tests/test_resilience.py:349-385: a failed decode step, recover(),
    and the trace finishes with the uninjected tokens; the replay checks
    every delivered token, and the registry counts one recovery."""
    prompts = _prompts(2, [5, 9, 3, 7])
    want = _want(reference, layout, prompts, 6)
    led = ConservationLedger()
    eng = _engine(models, layout, led)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    faults.inject("serving.step.decode", times=1, after=2)
    delivered, reports = _serve_recovering(eng, reqs)
    assert len(reports) == 1
    assert reports[0]["recovered_slots"] == 2
    assert reports[0]["replay_mismatches"] == 0
    assert sorted(r.rid for r in delivered) == [r.rid for r in reqs]
    assert [r.output_ids for r in reqs] == want
    reg = eng.registry
    assert reg.get("ptpu_serving_recoveries_total").value == 1
    assert reg.get("ptpu_serving_recover_replay_mismatch_total").value == 0
    _audited(eng, led)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fault_after_pool_written_recovers(models, reference, layout):
    """tests/test_serving_engine.py:254-290 and tests/test_paged_kv.py:290:
    the step fails AFTER the decode wrote the pools (metrics.on_step
    raises); the rebuilt engine re-prefills and never reads the stale
    column: the remaining tokens are the uninjected ones."""
    prompts = _prompts(8, [6, 9, 4])
    want = _want(reference, layout, prompts, 8)
    led = ConservationLedger()
    eng = _engine(models, layout, led)
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.step()
    eng.step()

    def boom(n):
        raise RuntimeError("device fault mid-step")
    orig, eng.metrics.on_step = eng.metrics.on_step, boom
    with pytest.raises(RuntimeError, match="device fault"):
        eng.step()
    eng.metrics.on_step = orig
    with pytest.raises(EngineBroken, match="recover"):
        eng.step()
    report = eng.recover()
    assert report["recovered_slots"] >= 1
    assert report["replay_mismatches"] == 0
    eng.run()
    assert [r.output_ids for r in reqs] == want
    assert eng.cache.free_slots() == [0, 1]
    _audited(eng, led)


def test_finished_in_failed_step_delivered_once(models):
    """tests/test_serving_engine.py:292-330: a deadline sweep and a
    decode fault land in the same step; the expired request surfaces
    exactly once, through the recover() report."""
    clock = {"t": 0.0}
    led = ConservationLedger()
    eng = _engine(models, "contiguous", led, max_slots=1,
                  time_fn=lambda: clock["t"])
    a = eng.submit(np.arange(1, 6), max_new_tokens=6)
    b = eng.submit(np.arange(1, 6), max_new_tokens=6, deadline_s=1.0)
    eng.step()                            # a takes the slot; b queued
    faults.inject("serving.step.decode", times=1)
    clock["t"] = 5.0                      # b expires at the sweep...
    with pytest.raises(faults.InjectedFault):
        eng.step()                        # ...then the decode fails
    assert b.finished and b.finish_reason == "deadline"
    assert b.rid in eng.inflight_rids()   # owed, not lost
    report = eng.recover()
    assert [r.rid for r in report["finished"]] == [b.rid]
    done = eng.run()
    assert b not in done and a in done and a.finish_reason == "length"
    _audited(eng, led)


def test_proposer_pruned_and_tokens_held_through_recover(models,
                                                         reference):
    """tests/test_spec_decode.py:343: a verify fault breaks a
    speculative engine; recover() re-prefills, the proposer tracks only
    the surviving requests, and the tokens are the non-speculative
    reference's."""
    rng = np.random.RandomState(11)
    prompts = [np.tile(rng.randint(1, 100, (int(rng.randint(1, 3)),)),
                       8)[:int(rng.randint(4, 10))].astype(np.int64)
               for _ in range(3)]
    want = _want(reference, "paged", prompts, 8)
    led = ConservationLedger()
    eng = _engine(models, "paged", led, speculative=True, spec_k=4)
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.step()
    faults.inject("serving.decode.verify", times=1)
    with pytest.raises(faults.InjectedFault):
        eng.run()
    report = eng.recover()
    assert report["replay_mismatches"] == 0
    live = {r.rid for r in eng.cache.slots if r is not None}
    assert set(eng.proposer.tracked()) <= live
    eng.run()
    assert [r.output_ids for r in reqs] == want
    assert eng.proposer.tracked() == []
    _audited(eng, led)


def test_verify_fault_point_is_wired(models, reference):
    """tests/test_spec_decode.py:375: ``serving.decode.verify`` fires in
    the speculative step, and a non-speculative engine never evaluates
    it; the draft and resample points are wired too (a draft fault is
    contained to its row)."""
    prompt = np.arange(1, 7)
    want = _want(reference, "contiguous", [prompt], 4)
    plain = _engine(models, "contiguous")
    plain.submit(prompt, max_new_tokens=4)
    faults.inject("serving.decode.verify", times=1)
    plain.run()
    assert faults.hits("serving.decode.verify") == 0
    led = ConservationLedger()
    eng = _engine(models, "contiguous", led, max_slots=1,
                  speculative=True, spec_k=4)
    req = eng.submit(prompt, max_new_tokens=4)
    with pytest.raises(faults.InjectedFault):
        eng.run()
    assert faults.fired("serving.decode.verify") == 1
    eng.recover()
    faults.inject("serving.spec.draft", times=1)
    eng.run()
    assert req.output_ids == want[0]
    assert faults.hits("serving.spec.draft") >= 1
    assert faults.fired("serving.spec.draft") == \
        eng.spec_stats()["draft_faults"]
    _audited(eng, led)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_fault_requeues_whole_admission_batch(models, reference,
                                                      layout):
    """tests/test_resilience.py:387-440: a prefill fault on the first
    admission requeues the whole batch in FCFS order (page reservations
    returned); after recover() every request is served with the
    uninjected tokens."""
    prompts = _prompts(4, [5, 5, 5])
    want = _want(reference, layout, prompts, 3)
    led = ConservationLedger()
    eng = _engine(models, layout, led, max_slots=3)
    reqs = [eng.submit(p, max_new_tokens=3) for p in prompts]
    faults.inject("serving.step.prefill", times=1)
    with pytest.raises(faults.InjectedFault):
        eng.step()
    assert eng.scheduler.pending() == reqs        # all back, FCFS kept
    if layout == "paged":
        assert eng.cache.committed_pages == 0 and not eng.cache._plans
    assert eng.recover()["recovered_slots"] == 0
    done = eng.run()
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    assert [r.output_ids for r in reqs] == want
    _audited(eng, led)


def test_paged_prefill_fault_after_claim_returns_pages(models, reference):
    """``serving.prefill.paged`` fires with the pages claimed and the
    table row live: the abort returns every page, the request is
    requeued, and the retry after recover() gives the same tokens."""
    prompts = _prompts(5, [12, 7])
    want = _want(reference, "paged", prompts, 5)
    led = ConservationLedger()
    eng = _engine(models, "paged", led)
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    free0 = eng.cache.free_page_count()
    faults.inject("serving.prefill.paged", times=1)
    with pytest.raises(faults.InjectedFault):
        eng.step()
    assert eng.cache.free_page_count() == free0
    assert eng.cache.committed_pages == 0
    assert eng.scheduler.pending() == reqs
    eng.recover()
    eng.run()
    assert [r.output_ids for r in reqs] == want
    _audited(eng, led)


@pytest.mark.parametrize("layout,chunk", [("contiguous", None),
                                          ("paged", None), ("paged", 8)],
                         ids=["contiguous", "paged", "paged-chunked"])
def test_adopt_request_with_delivered_tokens(models, reference, layout,
                                             chunk):
    """A request served part-way by one engine (which then dies) is
    adopted by another: its admission runs the prompt's prefill (chunked
    too) and writes the delivered tokens by decode forwards, and the
    tokens go on as the uninjected run's, with no replay mismatch."""
    prompts = _prompts(6, [9, 14])
    want = _want(reference, layout, prompts, 7)
    first = _engine(models, layout)
    reqs = [first.submit(p, max_new_tokens=7) for p in prompts]
    for _ in range(3):
        first.step()
    assert all(1 < len(r.out_tokens) < 7 for r in reqs)
    led = ConservationLedger()
    eng = _engine(models, layout, led, prefill_chunk=chunk)
    resumed, resume = [], eng._resume

    def spy(rows):
        resumed.extend(r.rid for _, r, _ in rows)
        return resume(rows)
    eng._resume = spy
    for r in reqs:
        eng.adopt(r)
        led.on_submitted(r)       # audited where it first entered
    assert eng.probe() == {"broken": None, "queued": 2, "active": 0}
    done = eng.run()
    assert resumed == [r.rid for r in reqs]     # recover()'s route
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    assert [r.output_ids for r in reqs] == want
    assert eng.registry.get(
        "ptpu_serving_recover_replay_mismatch_total").value == 0
    _audited(eng, led)


@pytest.mark.parametrize("donor_new,reroutes", [(8, 0), (2, 1)],
                         ids=["donor-in-flight", "donor-finished"])
def test_recover_shared_prefix_in_admission_order(models, reference,
                                                  donor_new, reroutes):
    """Prefix sharing (the paged default): recover() writes the prompts
    again in admission order, each matching no more than its admission
    did. A request that shared a donor's pages from a LOWER slot matches
    them again (no reroute); when the donor has finished, its pages are
    gone from the rebuilt index and the prompt runs whole (one reroute).
    Either way the tokens are the uninjected ones."""
    rng = np.random.RandomState(9)
    shared = rng.randint(1, 100, (16,))                 # two pages of 8
    x = rng.randint(1, 100, (5,)).astype(np.int64)
    d, s = (np.concatenate([shared, rng.randint(1, 100, (n,))])
            .astype(np.int64) for n in (4, 6))
    want = _want(reference, "paged", [x, d, s], 8)
    led = ConservationLedger()
    eng = _engine(models, "paged", led, max_slots=3)
    rx = eng.submit(x, max_new_tokens=1)     # slot 0, done at admission
    rd = eng.submit(d, max_new_tokens=donor_new)
    eng.step()
    rs = eng.submit(s, max_new_tokens=8)
    eng.step()
    assert (rs.slot, rs._shared_len) == (0, 16)
    assert rd.finished == (donor_new == 2)
    faults.inject("serving.step.decode", times=1)
    with pytest.raises(faults.InjectedFault):
        eng.step()
    report = eng.recover()
    assert report["reroutes"] == reroutes
    assert report["replay_mismatches"] == 0
    assert rs._shared_len == 16 - 16 * reroutes
    eng.run()
    assert [rx.output_ids, rd.output_ids, rs.output_ids] == \
        [want[0][:1], want[1][:donor_new], want[2]]
    _audited(eng, led)


def test_drain_on_broken_engine_cancels(models):
    """tests/test_resilience.py:325: a caller that chooses shutdown over
    recover() gets its requests back cancelled, not EngineBroken."""
    led = ConservationLedger()
    eng = _engine(models, "paged", led, max_slots=1)
    r1 = eng.submit(np.arange(1, 6), max_new_tokens=10)
    r2 = eng.submit(np.arange(1, 6), max_new_tokens=10)
    faults.inject("serving.step.decode", times=1)
    with pytest.raises(faults.InjectedFault):
        eng.step()
    done = eng.drain()
    assert {r.rid for r in done} == {r1.rid, r2.rid}
    assert all(r.finish_reason == "cancelled" for r in done)
    assert all("broken" in str(r.error) for r in done)
    assert isinstance(r1.error, RequestCancelled)
    with pytest.raises(EngineClosed):
        eng.submit(np.arange(1, 6), 2)
    _audited(eng, led)


def test_flight_recorder_dumps_on_failed_step(models, tmp_path):
    """tests/test_observability.py:718: a failed step dumps the
    recorder's ring, with its error record and the engine's registry
    snapshot, into the recorder's dump_dir; recover() records itself."""
    reg = MetricRegistry()
    fr = FlightRecorder(capacity=8, dump_dir=str(tmp_path / "dumps"))
    eng = ServingEngine(models[1], max_slots=2, max_len=32, min_bucket=8,
                        kv_layout="contiguous", registry=reg,
                        flight_recorder=fr)
    req = eng.submit(np.arange(1, 5), 4)
    eng.step()
    faults.inject("serving.step.decode", times=1)
    with pytest.raises(faults.InjectedFault):
        eng.step()
    dumps = os.listdir(tmp_path / "dumps")
    assert len(dumps) == 1 and dumps[0].startswith("ptpu_flight_")
    payload = json.load(open(tmp_path / "dumps" / dumps[0]))
    assert "raised InjectedFault" in payload["reason"]
    kinds = [r["kind"] for r in payload["records"]]
    assert kinds == ["serving.step", "serving.step_error"]
    metrics = payload["metrics"]["metrics"]
    assert "ptpu_serving_step_seconds" in metrics
    assert metrics["ptpu_serving_requests_total"]["samples"][0][
        "value"] == 1
    eng.recover()
    assert fr.snapshot()[-1]["kind"] == "serving.recover"
    eng.run()
    assert req.finished and len(req.output_ids) == 4
    assert os.listdir(tmp_path) == ["dumps"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_registry_families_match_reference(models, reference, layout):
    """The port's engine registers the reference's ptpu_serving_*
    families and the KV tier's promotion wait, with the same kinds, and
    its step publishes the queue, slot and page gauges."""
    led = ConservationLedger()
    eng = _engine(models, layout, led)
    eng.submit(np.arange(1, 6), 3)
    eng.run()
    ref_reg = reference[layout][1]
    want = {n: ref_reg.get(n).kind for n in ref_reg.families()}
    got = {n: eng.registry.get(n).kind for n in eng.registry.families()}
    assert got == want
    # the last step decoded the request's last token
    assert eng.registry.get("ptpu_serving_active_slots").value == 1
    assert eng.registry.get("ptpu_serving_queue_depth").value == 0
    assert eng.registry.get("ptpu_serving_tokens_total").value == 3
    assert eng.inflight_rids() == set(eng.metrics.inflight_phases()) \
        == set()
    _audited(eng, led)
