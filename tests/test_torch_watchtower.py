"""paddle_tpu_torch's watchtower (observability/watchtower.py) against the
reference's (paddle_tpu/observability/watchtower.py), mirroring
tests/test_watchtower.py.

No model: each scenario is one operation sequence (registry
observations, fake telemetry, fake engines, a virtual clock) run once
through the reference's registry and watchtower and once through the
port's, and every readout is compared exactly (tolerance 0): the
incidents as JSON (kind, phase, summary, fingerprint, timestamps,
dedup counts, detail, request ids), the burn rates, ``healthz()``,
``to_json()`` and the rendered diagnosis. Then the port-only laws: the
hot path is one counter increment, the engine's step bumps it, and the
``recompiles`` stream reads ``None`` on the eager engine (it has no
``trace_counts``).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu.observability as ref_obs
import paddle_tpu.observability.watchtower as ref_wt
import paddle_tpu_torch.observability as port_obs
import paddle_tpu_torch.observability.watchtower as port_wt

TTFT = "ptpu_serving_ttft_seconds"
SIDES = ((ref_obs, ref_wt), (port_obs, port_wt))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wt(wt_mod, reg, clock, objectives=(), **kw):
    kw.setdefault("stall_after_s", None)
    kw.setdefault("anomaly_streams", False)
    kw.setdefault("eval_interval_s", 1.0)
    return wt_mod.Watchtower(registry=reg, time_fn=lambda: clock["t"],
                             objectives=objectives, **kw)


def _burn_objective(wt_mod, **kw):
    kw.setdefault("name", "ttft")
    kw.setdefault("threshold_s", 0.5)
    kw.setdefault("objective", 0.99)
    kw.setdefault("family", TTFT)
    kw.setdefault("phase", "queue")
    return wt_mod.SLOObjective(**kw)


def _js(incs):
    return [i.to_json() for i in incs]


def _readouts(wt):
    return {"incidents": _js(wt.incidents()), "burn": wt.burn_rates(),
            "healthz": wt.healthz(), "json": wt.to_json(),
            "diagnosis": wt.diagnose()}


def _both(scenario):
    """Run ``scenario(obs, wt_mod)`` on both sides; its outputs must be
    equal. Returns the port's."""
    outs = [scenario(obs, mod) for obs, mod in SIDES]
    assert outs[1] == outs[0]
    return outs[1]


# -- objectives, bucket snapping ------------------------------------------

def test_objective_validation_and_good_count():
    def scenario(obs, mod):
        out = []
        for kw in (dict(), dict(family=TTFT, objective=1.0)):
            with pytest.raises(ValueError) as e:
                mod.SLOObjective("x", threshold_s=1.0, **kw)
            out.append(str(e.value))
        h = {"buckets": {"0.1": 0, "0.5": 10, "1.0": 10, "+Inf": 10},
             "count": 10}
        out += [mod._good_count(h, t) for t in (0.3, 0.1, 5.0)]
        out.append([(o.name, o.threshold_s, o.objective, o.family,
                     o.phase) for o in mod.DEFAULT_OBJECTIVES])
        return out
    assert _both(scenario)[2:5] == [10, 0, 10]


# -- burn-rate engine ------------------------------------------------------

def test_burn_trips_on_budget_fire_and_not_on_good_traffic():
    def scenario(obs, mod):
        clock = {"t": 0.0}
        reg = obs.MetricRegistry()
        h = reg.histogram(TTFT, "d", buckets=(0.1, 0.5, 1.0))
        wt = _wt(mod, reg, clock, objectives=(_burn_objective(mod),))
        out = [_js(wt.flush())]
        for _ in range(50):
            h.observe(0.05)
        clock["t"] = 5.0
        out.append(_js(wt.flush()))
        for _ in range(40):
            h.observe(2.0)
        clock["t"] = 10.0
        out.append(_js(wt.flush()))
        out.append(_readouts(wt))
        c = reg.counter("ptpu_incidents_total", labels=("kind", "phase"))
        out.append(c.labels(kind="slo_burn", phase="queue").value)
        return out
    out = _both(scenario)
    assert [i["kind"] for i in out[2]] == ["slo_burn"] and out[4] == 1
    assert out[3]["healthz"]["ok"] is False


def test_burn_min_events_both_windows_and_priming():
    def scenario(obs, mod):
        clock = {"t": 0.0}
        reg = obs.MetricRegistry()
        h = reg.histogram(TTFT, "d", buckets=(0.1, 0.5, 1.0))
        wt = _wt(mod, reg, clock,
                 objectives=(_burn_objective(mod, min_events=5),))
        out = [_js(wt.flush())]
        for _ in range(3):
            h.observe(2.0)
        clock["t"] = 5.0
        out.append(_js(wt.flush()))
        for _ in range(10):
            h.observe(2.0)
        clock["t"] = 10.0
        out.append(_js(wt.flush()))
        for _ in range(200):
            h.observe(0.05)
        clock["t"] = 60.0
        out.append(_js(wt.flush()))
        out.append(wt.burn_rates())
        # history before attachment primes, never pages
        reg2 = obs.MetricRegistry()
        h2 = reg2.histogram(TTFT, "d", buckets=(0.1, 0.5, 1.0))
        for _ in range(100):
            h2.observe(2.0)
        wt2 = _wt(mod, reg2, clock, objectives=(_burn_objective(mod),))
        out += [_js(wt2.flush()), _readouts(wt2)]
        return out
    out = _both(scenario)
    assert out[1] == [] and out[3] == [] and out[5] == []


def test_burn_from_attribution_phase_with_breakdown():
    class FakeTel:
        def __init__(self):
            self.records = []

        def slo_attribution(self):
            return list(self.records)

        def aligned_spans(self):
            return [{"name": "serving.step", "ts": 1.0}]

        def spans_for(self, rid):
            return [{"name": "serving.prefill", "request_id": rid}]

    def scenario(obs, mod):
        clock = {"t": 0.0}
        reg = obs.MetricRegistry()
        tel = FakeTel()
        obj = mod.SLOObjective("queue_wait", threshold_s=1.0,
                               objective=0.99, phase="queue", min_events=3)
        wt = _wt(mod, reg, clock, objectives=(obj,), telemetry=tel)
        out = [_js(wt.flush())]
        tel.records = [{"request_id": i, "queue_s": 8.0, "decode_s": 1.0,
                        "kv_promotion_s": 0.5} for i in range(8)]
        clock["t"] = 5.0
        out.append(_js(wt.flush()))
        out.append(_readouts(wt))
        out.append(mod.render_diagnosis(wt.to_json()))
        return out
    out = _both(scenario)
    inc = out[1][0]
    assert inc["phase"] == "queue" and inc["request_ids"]
    assert inc["trace"] and "admission-bound" in out[3]


# -- anomaly detectors -------------------------------------------------------

def test_detectors_on_the_same_streams():
    rng = np.random.RandomState(0)
    streams = [[1.0] * 30 + [500.0],
               [1, 1000, 1, 1000, 2, 999],
               list(rng.lognormal(0.0, 0.3, 200)) + [40.0, 1.0, 60.0],
               [3.0] * 20 + [500.0] + [3.0] * 5 + [500.0]]

    def scenario(obs, mod):
        out = []
        for xs in streams:
            e = mod.EwmaDetector(alpha=0.3, k=6.0, warmup=8)
            z = mod.RobustZDetector(window=64, z=8.0, min_samples=8)
            out.append([(e.update(x), z.update(x)) for x in xs])
            out.append((e.mean, e.var, e.n, list(z.samples)))
        return out
    out = _both(scenario)
    assert out[0][-1] == (True, True)
    assert not any(t for t, _ in out[2])          # warmup never trips


def test_anomaly_stream_raises_incident():
    def scenario(obs, mod):
        clock = {"t": 0.0}
        reg = obs.MetricRegistry()
        depth = reg.gauge("ptpu_serving_queue_depth", "d")
        step = reg.histogram("ptpu_serving_step_seconds", "d")
        promo = reg.histogram("ptpu_kv_promotion_wait_seconds", "d")
        wt = _wt(mod, reg, clock, anomaly_streams=True)
        out = []
        depth.set(3.0)
        for i in range(30):
            clock["t"] = float(i)
            step.observe(0.01 + 0.001 * (i % 3))
            promo.observe(0.002)
            out.append(_js(wt.flush()))
        depth.set(5000.0)
        promo.observe(9.0)
        clock["t"] = 40.0
        out.append(_js(wt.flush()))
        out.append(_readouts(wt))
        return out
    out = _both(scenario)
    assert ("anomaly", "queue") in {(i["kind"], i["phase"])
                                    for i in out[30]}


# -- stall / orphan / death / heartbeat --------------------------------------

def _stall_registry(obs, steps=5, depth=4.0, active=2.0):
    reg = obs.MetricRegistry()
    h = reg.histogram("ptpu_serving_step_seconds", "d")
    for _ in range(steps):
        h.observe(0.01)
    reg.gauge("ptpu_serving_queue_depth", "d").set(depth)
    reg.gauge("ptpu_serving_active_slots", "d").set(active)
    return reg, h


def test_stall_detector_pages_resets_and_ignores_idle():
    def scenario(obs, mod):
        clock = {"t": 0.0}
        reg, h = _stall_registry(obs)
        wt = _wt(mod, reg, clock, stall_after_s=10.0)
        out = [_js(wt.flush())]
        clock["t"] = 5.0
        out.append(_js(wt.flush()))
        clock["t"] = 20.0
        out.append(_js(wt.flush()))
        wt2 = _wt(mod, reg, clock, stall_after_s=10.0)
        out.append(_js(wt2.flush()))
        for t in (25.0, 40.0, 60.0):
            h.observe(0.01)
            clock["t"] = t
            out.append(_js(wt2.flush()))
        idle, _ = _stall_registry(obs, depth=0.0, active=0.0)
        wt3 = _wt(mod, idle, clock, stall_after_s=10.0)
        out.append(_js(wt3.flush()))
        clock["t"] = 1000.0
        out.append(_js(wt3.flush()))
        return out
    out = _both(scenario)
    assert [(i["kind"], i["phase"]) for i in out[2]] == [("stall", "decode")]
    assert all(o == [] for o in out[3:])


def test_orphan_death_and_heartbeat_detectors():
    class FakeMetrics:
        def __init__(self):
            self.inflight = {}

        def inflight_phases(self):
            return dict(self.inflight)

    class FakeEngine:
        metrics = None
        recorder = None

        def inflight_rids(self):
            return set()

    class FakeTel:
        def worker_snapshots(self):
            return {"w0": {"ts": 0.0}, "w1": {"ts": 95.0}}

        def slo_attribution(self):
            return []

        def aligned_spans(self):
            return []

    def scenario(obs, mod):
        out = []
        clock = {"t": 0.0}
        reg = obs.MetricRegistry()
        m, eng = FakeMetrics(), FakeEngine()
        eng.metrics = m
        wt = _wt(mod, reg, clock).attach_engine(eng)
        m.inflight = {7: {"phase": "kv_promotion", "age_s": 3.0}}
        out.append(_js(wt.flush()))
        clock["t"] = 1.0
        out.append(_js(wt.flush()))
        clock["t"] = 2.0
        out.append(_js(wt.flush()))
        m.inflight = {9: {"phase": "queue", "age_s": 0.1}}
        clock["t"] = 3.0
        out.append(_js(wt.flush()))
        m.inflight = {}
        clock["t"] = 4.0
        out.append(_js(wt.flush()))
        # replica deaths: a partition is a dispatch fault, not a death
        reg2 = obs.MetricRegistry()
        deaths = reg2.counter("ptpu_router_replica_deaths_total", "d",
                              labels=("replica", "reason"))
        deaths.labels(replica="0", reason="coop").inc()
        wt2 = _wt(mod, reg2, clock)
        out.append(_js(wt2.flush()))
        deaths.labels(replica="1", reason="unreachable").inc()
        clock["t"] = 5.0
        out.append(_js(wt2.flush()))
        deaths.labels(replica="0", reason="died mid-step").inc()
        clock["t"] = 6.0
        out.append(_js(wt2.flush()))
        # heartbeats
        clock["t"] = 10.0
        wt3 = _wt(mod, obs.MetricRegistry(), clock, telemetry=FakeTel(),
                  heartbeat_max_age_s=30.0)
        out.append(_js(wt3.flush()))
        clock["t"] = 100.0
        out.append(_js(wt3.flush()))
        return out
    out = _both(scenario)
    assert [(i["kind"], i["phase"]) for i in out[1]] \
        == [("request_orphaned", "kv_promotion")]
    assert [(i["kind"], i["phase"]) for i in out[6]] \
        == [("partition", "dispatch")]
    assert [(i["kind"], i["phase"]) for i in out[7]] \
        == [("worker_death", "failover")]
    assert [(i["kind"], i["phase"]) for i in out[9]] \
        == [("stall", "failover")]


# -- incident plumbing and readouts ------------------------------------------

def test_incident_dedup_eviction_and_readouts():
    class Flappy:
        def snapshot(self):
            return {"brownout": {"step": 10, "flips": 40, "dwell": 4,
                                 "level": 2, "sheds_by_tier": {2: 1}},
                    "chunk": {"mult": 2, "step": 10, "adaptations": 1,
                              "dwell": 2}}

    class SpecEngine:
        metrics = None
        recorder = None
        speculative = True

        def spec_stats(self):
            return {"proposer": "draft", "accepted_per_step": 2.5,
                    "tuner": {"classes": {"greedy": {"k": 3,
                                                     "on": True}}}}

    def scenario(obs, mod):
        clock = {"t": 0.0}
        reg = obs.MetricRegistry()
        h = reg.histogram(TTFT, "d", buckets=(0.1, 0.5, 1.0))
        wt = _wt(mod, reg, clock, objectives=(_burn_objective(mod),),
                 dedup_window_s=100.0, max_incidents=4)
        out = [_js(wt.flush())]
        for t in (5.0, 10.0, 15.0):
            for _ in range(40):
                h.observe(2.0)
            clock["t"] = t
            out.append(_js(wt.flush()))
        for i in range(6):
            wt._raise([], kind="stall", phase="decode", key=f"k{i}",
                      now=clock["t"], summary="s", detail={})
        out.append(_readouts(wt))
        out.append(json.dumps(wt.to_json()))
        inc = mod.Incident(kind="stall", phase="decode", summary="s",
                           ts=1.0, fingerprint="ab", detail={"x": 1},
                           request_ids=(3,), count=2, last_ts=4.0)
        out.append(json.loads(json.dumps(inc.to_json())))
        wt2 = _wt(mod, obs.MetricRegistry(), clock).attach_control(Flappy())
        wt2.attach_engine(SpecEngine())
        out.append(_js(wt2.flush()))
        clock["t"] = 20.0
        out.append(_js(wt2.flush()))
        out.append(_readouts(wt2))
        clean = _wt(mod, obs.MetricRegistry(), clock)
        clean.flush()
        out.append(_readouts(clean))
        return out
    out = _both(scenario)
    assert len(out[4]["incidents"]) == 4
    assert out[10]["diagnosis"] == "watchtower: healthy — no incidents"
    assert "controller_flapping" in out[9]["diagnosis"]
    assert "speculation: draft accepted 2.5" in out[9]["diagnosis"]


# -- port-only: the hot path and the engine hook -----------------------------

def test_hot_path_is_one_counter_and_poll_is_one_clock_read():
    """``observe_step`` never touches the lock, the clock or the
    registry; ``poll`` between window boundaries is one clock read and
    no evaluation."""
    class CountingLock:
        def __init__(self, inner):
            self.inner = inner
            self.acquisitions = 0

        def __enter__(self):
            self.acquisitions += 1
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    clock = {"t": 0.0, "reads": 0}

    def now():
        clock["reads"] += 1
        return clock["t"]

    wt = port_wt.Watchtower(registry=port_obs.MetricRegistry(),
                            time_fn=now, objectives=(),
                            eval_interval_s=100.0, stall_after_s=None,
                            anomaly_streams=False)
    evals = []
    orig = wt._evaluate
    wt._evaluate = lambda t: (evals.append(t), orig(t))[1]
    wt.flush()
    probe = CountingLock(wt._lock)
    wt._lock = probe
    clock["reads"] = 0
    for _ in range(1000):
        wt.observe_step()
    assert clock["reads"] == 0 and probe.acquisitions == 0
    assert wt._steps == 1000
    for _ in range(1000):
        assert wt.poll() == []
    assert clock["reads"] == 1000 and probe.acquisitions == 0
    assert len(evals) == 1
    clock["t"] = 200.0
    wt.poll()
    assert probe.acquisitions == 1 and len(evals) == 2


@pytest.fixture(scope="module")
def engine_model():
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    cfg = llama_tiny_config(num_hidden_layers=1, hidden_size=32,
                            intermediate_size=64, num_attention_heads=2)
    return LlamaForCausalLM(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def test_engine_step_bumps_the_counter_and_nothing_else(engine_model):
    """Attached to the port's engine: each successful step is one
    ``observe_step`` (no clock read of the watchtower's, no evaluation),
    the ``recompiles`` stream reads ``None`` (the eager engine has no
    ``trace_counts``), and a clean run raises no incident while a
    request dropped from the engine's books is an orphan attributed to
    its last phase."""
    from paddle_tpu_torch.serving import ServingEngine
    reads = {"n": 0}
    clock = {"t": 0.0}

    def now():
        reads["n"] += 1
        return clock["t"]
    reg = port_obs.MetricRegistry()
    eng = ServingEngine(engine_model, max_slots=2, max_len=32,
                        min_bucket=8, registry=reg)
    wt = port_wt.Watchtower(registry=reg, time_fn=now,
                            stall_after_s=None).attach_engine(eng)
    assert eng._watchtower is wt and not hasattr(eng, "trace_counts")
    for p in (np.arange(1, 6), np.arange(3, 12)):
        eng.submit(p, max_new_tokens=4)
    reads["n"] = 0
    steps = 0
    while eng.has_work():
        eng.step()
        steps += 1
    assert wt._steps == steps and reads["n"] == 0
    view = port_wt._MetricView(reg.to_json())
    assert wt._read_stream("recompiles", view) is None
    assert wt.flush() == [] and wt.flush() == []
    r = eng.submit(np.arange(1, 4), max_new_tokens=2)
    eng.scheduler.remove(r)                  # dropped, metrics still hold it
    clock["t"] = 10.0
    assert wt.flush() == []                  # first sighting
    incs = wt.flush()
    assert [(i.kind, i.phase, i.request_ids) for i in incs] \
        == [("request_orphaned", "queue", (r.rid,))]
    assert wt.healthz()["ok"] is False
