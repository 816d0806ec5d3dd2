"""paddle_tpu_torch's host-only serving modules against the reference's
(no model): the same operation sequences go through the reference module
and the port's copy, and the outputs are compared exactly.

- faults (paddle_tpu/resilience/faults.py): the firing sequence, hit and
  fire counts for ``times``/``after``, env specs (reload, malformed),
  seeded rates and scoped rules (tests/test_resilience.py:42-124);
- the metric registry: identical Prometheus exposition and JSON trees
  after the same operations (labels, escaping, the cardinality guard,
  histogram buckets and percentiles, NaN, reset), and the same errors
  (tests/test_observability.py:25-170);
- spans: nesting, request ids and bindings, as trace-buffer records
  (the reference's forward to its profiler; the port's open a
  ``torch.profiler`` range, checked here too);
- the flight recorder: the ring and a dump to ``tmp_path``
  (tests/test_observability.py:225-270);
- ``ConservationLedger`` and ``token_prefix_violations``: the same
  verdicts on the same books;
- ``Actuator`` / ``ChunkBudgetController``: the same decisions on the
  same depth and stall stream (tests/test_control.py:189-240), a faulted
  actuator included;
- ``FIFOScheduler.admissions`` with ``lookahead``: the same picks and
  queue on random claim patterns, lookahead 0 strict FCFS;
- ``EngineMetrics``: the same summary, ``inflight_phases()`` and
  registry exposition on a fake clock, ``stalled`` submissions included.
"""
import json
import math
import os
import types

import numpy as np
import pytest
import torch

import paddle_tpu.observability as ref_obs
import paddle_tpu.resilience.faults as ref_faults
import paddle_tpu.resilience.invariants as ref_inv
import paddle_tpu.serving.control as ref_control
import paddle_tpu.serving.metrics as ref_metrics
import paddle_tpu.serving.scheduler as ref_sched
import paddle_tpu_torch.observability as port_obs
import paddle_tpu_torch.resilience.faults as port_faults
import paddle_tpu_torch.resilience.invariants as port_inv
import paddle_tpu_torch.serving.control as port_control
import paddle_tpu_torch.serving.metrics as port_metrics
import paddle_tpu_torch.serving.scheduler as port_sched

FAULTS = (ref_faults, port_faults)
OBS = (ref_obs, port_obs)


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in FAULTS:
        f.clear()
        f.reset_counts()
    yield
    for f in FAULTS:
        f.clear()


# -- faults -------------------------------------------------------------

def _fire(f, point, n):
    out = []
    for _ in range(n):
        try:
            f.maybe_fail(point)
            out.append(0)
        except f.InjectedFault as e:
            out.append(e.hit)
        except ConnectionError:
            out.append(-1)
    return out


def _times_after(f):
    f.inject("t.p", times=2, after=1)
    seq = _fire(f, "t.p", 5)
    counts = (f.hits("t.p"), f.fired("t.p"))
    f.clear("t.p")
    return seq + _fire(f, "t.p", 1) + list(counts)


def _seeded_rate(f):
    f.inject("t.rate", rate=0.5, seed=7)
    return _fire(f, "t.rate", 40)


def _scoped(f):
    f.inject("t.s", times=100)
    with f.injected("t.s", times=1, exc=ConnectionError):
        inner = _fire(f, "t.s", 2)
    return inner + _fire(f, "t.s", 1)


@pytest.mark.parametrize("scenario", [_times_after, _seeded_rate, _scoped],
                         ids=["times_after", "seeded_rate", "scoped"])
def test_fault_firing_sequences_match(scenario):
    got = [scenario(f) for f in FAULTS]
    assert got[0] == got[1]
    assert any(got[1])


def test_fault_env_specs_match(monkeypatch):
    seqs = []
    for f in FAULTS:
        out = []
        monkeypatch.setenv("PTPU_FAULTS", "env.p:1@1,env.q:p0.5~seed3")
        out += _fire(f, "env.p", 3) + _fire(f, "env.q", 16)
        # an env change re-arms from the new spec at the next hit
        monkeypatch.setenv("PTPU_FAULTS", "env.p:1")
        out += _fire(f, "env.p", 2)
        # malformed specs arm nothing
        monkeypatch.setenv("PTPU_FAULTS", "no-colon-entry")
        out += _fire(f, "env.p", 1)
        monkeypatch.setenv("PTPU_FAULTS", "")
        out += _fire(f, "env.p", 1)
        out.append(sorted(f.fired().items()))
        seqs.append(out)
        monkeypatch.delenv("PTPU_FAULTS")
        f.maybe_fail("env.p")              # reload the empty spec
        f.clear()
    assert seqs[0] == seqs[1]
    parsed = [sorted((p, r.times, r.after, r.rate) for p, r in
                     f.parse_spec("a.b:2@3, c:p0.25~seed9").items())
              for f in FAULTS]
    assert parsed[0] == parsed[1]


def test_fired_fault_bumps_port_counter():
    fam = port_obs.default_registry().counter(
        "ptpu_fault_injections_total",
        "deliberately injected faults (resilience.faults)",
        labels=("point",))
    before = fam.labels(point="t.obs").value
    port_faults.inject("t.obs", times=1)
    with pytest.raises(port_faults.InjectedFault):
        port_faults.maybe_fail("t.obs")
    assert fam.labels(point="t.obs").value == before + 1
    assert set(port_faults.KNOWN_POINTS) >= {
        "serving.step.decode", "serving.decode.verify",
        "serving.step.prefill", "serving.prefill.paged",
        "serving.prefill.chunk", "serving.spec.draft",
        "serving.spec.resample", "control.chunk"}


# -- registry -------------------------------------------------------------

def _registry_ops(obs):
    reg = obs.MetricRegistry(time_fn=lambda: 123.0, max_label_sets=3)
    out = []
    c = reg.counter("ptpu_t_req_total", "requests", labels=("kind",))
    c.labels(kind="a").inc(3)
    c.labels(kind='we"ird\n').inc()
    c.labels(kind="b").inc(0.5)
    for bad in (lambda: c.labels(kind="d"), lambda: c.labels(nope="x"),
                lambda: c.inc(), lambda: c.labels(kind="a").inc(-1),
                lambda: reg.gauge("ptpu_t_req_total"),
                lambda: reg.counter("bad name!")):
        try:
            bad()
            out.append("ok")
        except obs.MetricError as e:
            out.append(str(e))
    g = reg.gauge("ptpu_t_occ", "occupancy\nsecond line")
    g.set(0.75)
    g.inc()
    g.dec(0.25)
    h = reg.histogram("ptpu_t_wait_seconds", "wait", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 50.0, float("nan")):
        h.observe(v)
    hd = reg.histogram("ptpu_t_default_seconds", "default buckets")
    rng = np.random.RandomState(0)
    for v in rng.exponential(0.05, 200):
        hd.observe(float(v))
    reg.histogram("ptpu_t_unused_seconds", "never observed",
                  labels=("x",))
    try:
        reg.histogram("ptpu_t_wait_seconds", buckets=(0.5,))
        out.append("ok")
    except obs.MetricError as e:
        out.append(str(e))
    nan = reg.gauge("ptpu_t_nan")
    nan.set(float("nan"))
    out += [reg.to_prometheus(), json.dumps(reg.to_json(), sort_keys=True),
            [hd.percentile(q) for q in (0, 50, 90, 99, 100)],
            hd.quantile(0.5), h.count, h.sum == h.sum, reg.families()]
    reg.reset()
    out.append(reg.to_prometheus())
    return out


def test_registry_exposition_matches_reference():
    ref, port = (_registry_ops(o) for o in OBS)
    assert port == ref
    text = port[7]
    assert 'ptpu_t_req_total{kind="we\\"ird\\n"} 1' in text
    assert "ptpu_t_nan NaN" in text
    assert 'ptpu_t_wait_seconds_bucket{le="+Inf"} 4' in text
    assert all("cardinality" in e or "labels" in e or "decrease" in e
               or "registered" in e or "invalid" in e for e in port[:7])


# -- spans ------------------------------------------------------------------

def _span_records(obs):
    buf = obs.TraceBuffer(capacity=16, time_fn=iter(range(100)).__next__)
    prev = obs.install_trace_buffer(buf)
    obs.bind_request(7, obs.TraceContext.for_request(7, parent_span_id=3))
    try:
        with obs.span("outer", request_id=7, bucket=16) as sp:
            sp.set_attr("tokens", 3)
            with obs.span("inner", slot=1):
                assert obs.active_context().trace_id == "req-7"
        try:
            with obs.span("failing", request_id=9):
                raise ValueError("x")
        except ValueError:
            pass
        with obs.span("explicit",
                      ctx=obs.TraceContext("tr", parent_span_id=5)):
            pass
    finally:
        obs.install_trace_buffer(prev)
        obs.clear_bindings()
    recs = buf.drain()
    for r in recs:
        del r["pid"]
    return recs, (buf.recorded_total, buf.drained_total,
                  buf.dropped_total), obs.active_context()


def test_span_nesting_and_request_ids_match_reference():
    ref, port = (_span_records(o) for o in OBS)
    assert port == ref
    names = [r["name"] for r in port[0]]
    assert names == ["inner", "outer", "failing", "explicit"]
    assert port[0][0]["trace"] == port[0][1]["trace"] == "req-7"
    assert port[0][1]["attrs"] == {"request_id": 7, "bucket": 16,
                                   "tokens": 3}
    assert port[0][2]["error"] == "ValueError"


def test_span_opens_a_torch_profiler_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with port_obs.span("t.request", request_id=42):
            torch.ones(4).sum()
    assert "t.request" in {e.name for e in prof.events()}
    # outside a profile: no range is opened
    assert port_obs.span("t.idle").__enter__()._ev is None


# -- flight recorder ----------------------------------------------------------

def test_flight_recorder_matches_reference(tmp_path):
    payloads = []
    for i, obs in enumerate(OBS):
        clock = {"t": 0.0}
        reg = obs.MetricRegistry(time_fn=lambda: 5.0)
        reg.counter("ptpu_t_x_total", "x").inc(2)
        fr = obs.FlightRecorder(capacity=4, time_fn=lambda: clock["t"],
                                dump_dir=str(tmp_path / str(i)))
        for step in range(7):
            clock["t"] = float(step)
            fr.record("step", step=step, evicted=[(step, "length")])
        assert len(fr) == 4
        path = fr.dump(reason="test dump", registry=reg)
        assert os.path.dirname(path) == str(tmp_path / str(i))
        payload = json.load(open(path))
        del payload["pid"]
        payloads.append(payload)
        fr.clear()
        assert len(fr) == 0
    assert payloads[0] == payloads[1]
    assert [r["step"] for r in payloads[1]["records"]] == [3, 4, 5, 6]
    assert payloads[1]["metrics"]["metrics"]["ptpu_t_x_total"][
        "samples"][0]["value"] == 2


def test_flight_recorder_dump_dir_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PTPU_FLIGHT_DIR", str(tmp_path))
    fr = port_obs.FlightRecorder(capacity=2)
    fr.record("step", step=0)
    path = fr.dump(reason="env")
    assert os.path.dirname(path) == str(tmp_path)
    assert json.load(open(path))["records"][0]["kind"] == "step"


# -- conservation laws ----------------------------------------------------------

def _req(rid, finished=True, reason="length", out=()):
    return types.SimpleNamespace(rid=rid, finished=finished,
                                 finish_reason=reason,
                                 out_tokens=list(out), max_new_tokens=3)


def _ledger_books(inv):
    books = []
    for ops in (
            [("s", 0), ("s", 1), ("d", 0, "step"), ("d", 1, "recover")],
            [("s", 0), ("s", 1), ("d", 0, "step")],                # lost
            [("s", 0), ("d", 0, "step"), ("d", 0, "drain")],       # twice
            [("d", 5, "step")],                                    # phantom
            [("s", 0), ("s", 0), ("d", 0, "cancel")],              # resubmit
            [("a",), ("a",), ("s", 0), ("r",), ("d", 0, "step")],
            [("a",), ("a",), ("s", 0), ("d", 0, "step")],   # no outcome
            [("s", 2), ("d", 2, "step")]):                  # not terminal
        led = inv.ConservationLedger()
        reqs = {0: _req(0), 1: _req(1, reason="eos"),
                2: _req(2, finished=False, reason=None), 5: _req(5)}
        for op in ops:
            if op[0] == "s":
                led.on_submitted(reqs[op[1]])
            elif op[0] == "d":
                led.on_delivered(reqs[op[1]], via=op[2])
            elif op[0] == "a":
                led.on_attempt()
            else:
                led.on_rejected("t", "full")
        books.append(led.violations())
        try:
            led.check()
            books.append(None)
        except inv.InvariantViolation as e:
            books.append(e.violations)
    pairs = [(_req(0, out=[1, 2, 3]), [1, 2, 3, 4]),
             (_req(1, reason="deadline", out=[1, 9]), [1, 2, 3]),
             (_req(2, reason="length", out=[1, 2]), [1, 2, 3]),
             (_req(3, out=[1, 2, 3, 4, 5]), [1, 2])]
    books.append(inv.token_prefix_violations(pairs))
    return books


def test_conservation_verdicts_match_reference():
    ref, port = (_ledger_books(m) for m in (ref_inv, port_inv))
    assert port == ref
    assert port[0] == [] and port[1] is None and port[10] == []
    assert all(port[i] for i in (2, 4, 6, 8, 12, 14, 16))


# -- control ------------------------------------------------------------------

STREAM = [(10.0, 0.0)] * 4 + [(10.0, 20.0)] * 2 + [(2.0, 0.0)] * 4 \
    + [(0.0, 0.0)] * 3 + [(9.0, 1.0)] * 5 + [(0.2, 30.0)] * 4


def _controller_decisions(control, faults, obs, faulted):
    reg = obs.MetricRegistry()
    act = control.Actuator(window=4, budgets={"chunk": 2}, registry=reg)
    c = control.ChunkBudgetController(
        raise_depth=4.0, lower_depth=1.0, stall_brake=8.0, alpha=0.5,
        dwell=2, mults=(1, 2, 4), actuator=act, registry=reg)
    if faulted:
        faults.inject("control.chunk", times=2, after=1)
    out = []
    for depth, stall in STREAM:
        act.on_step()
        out.append(c.step_budget(8, depth=depth, stall=stall))
    return out, c.snapshot(), act.snapshot(), reg.to_prometheus()


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["clean", "faulted_actuator"])
def test_chunk_budget_decisions_match_reference(faulted):
    got = [_controller_decisions(c, f, o, faulted) for c, f, o in
           ((ref_control, ref_faults, ref_obs),
            (port_control, port_faults, port_obs))]
    assert got[1] == got[0]
    budgets, snap, act, _ = got[1]
    assert set(budgets) > {8}
    if faulted:
        assert act["faulted"]["chunk"] == 2


def test_chunk_budget_raises_lowers_and_brakes():
    """tests/test_control.py:205-222 on the port."""
    c = port_control.ChunkBudgetController(
        raise_depth=4.0, lower_depth=1.0, stall_brake=8.0, alpha=1.0,
        dwell=2, mults=(1, 2, 4), registry=port_obs.MetricRegistry())
    assert c.step_budget(8, depth=10.0) == 8
    assert c.step_budget(8, depth=10.0) == 16
    assert c.step_budget(8, depth=10.0) == 16
    assert c.step_budget(8, depth=10.0) == 32
    c.step_budget(8, depth=10.0, stall=20.0)
    assert c.step_budget(8, depth=10.0, stall=20.0) == 16
    for _ in range(4):
        assert c.step_budget(8, depth=2.0) == 16
    assert c.step_budget(8, depth=0.0) == 8
    assert c.adaptations == c.flips == 4
    for bad in (dict(raise_depth=2.0, lower_depth=2.0), dict(mults=(0, 1)),
                dict(mults=(1, 1, 2)), dict(mults=(4, 2, 1)), dict(dwell=0),
                dict(alpha=0.0)):
        with pytest.raises(ValueError):
            port_control.ChunkBudgetController(
                registry=port_obs.MetricRegistry(), **bad)
    with pytest.raises(ValueError):
        port_control.Actuator(window=0)


# -- scheduler lookahead ----------------------------------------------------

def _admission_trace(sched_mod, seed):
    from paddle_tpu.serving.sampling import SamplingParams as RefSP
    from paddle_tpu_torch.serving.sampling import SamplingParams as PortSP
    sp = RefSP if sched_mod is ref_sched else PortSP
    rng = np.random.RandomState(seed)
    s = sched_mod.FIFOScheduler()
    nxt = 0
    out = []
    budget = {"pages": 0}

    def claim(req):
        if req.prompt_len <= budget["pages"]:
            budget["pages"] -= req.prompt_len
            return True
        return False
    for _ in range(30):
        for _ in range(int(rng.randint(0, 4))):
            s.add(sched_mod.Request(
                rid=nxt, prompt=np.ones(int(rng.randint(1, 12)), np.int64),
                max_new_tokens=1, sampling=sp()))
            nxt += 1
        budget["pages"] = int(rng.randint(0, 20))
        free = sorted(rng.choice(8, int(rng.randint(0, 5)), replace=False))
        look = int(rng.randint(0, 4))
        picked = s.admissions([int(f) for f in free], claim=claim,
                              lookahead=look)
        out.append(([(sl, r.rid) for sl, r in picked],
                    [r.rid for r in s.pending()]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookahead_admissions_match_reference(seed):
    ref, port = (_admission_trace(m, seed) for m in (ref_sched, port_sched))
    assert port == ref
    assert any(p for p, _ in port)


def test_lookahead_zero_is_strict_fcfs():
    """tests/test_serving_chunked.py:450-470 on the port."""
    from paddle_tpu_torch.serving.sampling import SamplingParams

    def mk(rid, L):
        return port_sched.Request(rid=rid, prompt=np.ones((L,), np.int64),
                                  max_new_tokens=1, sampling=SamplingParams())
    sched = port_sched.FIFOScheduler()
    for rid, L in enumerate((10, 3, 4)):
        sched.add(mk(rid, L))
    assert sched.admissions([0, 1], claim=lambda r: r.prompt_len < 5) == []
    assert [r.rid for r in sched.pending()] == [0, 1, 2]
    picked = sched.admissions([0, 1], claim=lambda r: r.prompt_len < 5,
                              lookahead=2)
    assert [(s, r.rid) for s, r in picked] == [(0, 1), (1, 2)]
    assert [r.rid for r in sched.pending()] == [0]


# -- engine metrics -------------------------------------------------------------

def _metrics_run(mod, obs):
    clock = {"t": 0.0}
    reg = obs.MetricRegistry(time_fn=lambda: 0.0)
    m = mod.EngineMetrics(4, lambda: clock["t"], registry=reg)
    phases = []
    for step in range(12):
        clock["t"] = step * 0.01 + (step % 3) * 0.004
        if step < 4:
            m.on_submit(step, stalled=step > 0)
        if 1 <= step <= 4:
            m.on_first_prefill(step - 1)
        for rid in range(4):
            if rid + 1 < step < rid + 8:
                m.on_token(rid)
        if step == 9:
            m.on_finished(0)
        m.on_draft(0.001 * step)
        if step in (3, 6):
            m.on_promotion_start(step - 3)
            phases.append(sorted(
                (rid, p["phase"]) for rid, p in
                m.inflight_phases().items()))
            m.on_promotion(step - 3, 0.002 * step)
        m.on_step(min(step, 4))
        phases.append(sorted((rid, p["phase"], round(p["age_s"], 9))
                             for rid, p in m.inflight_phases().items()))
    return m.summary(), phases, reg.to_prometheus(), m.snapshot_windows()


def test_engine_metrics_match_reference():
    ref, port = (_metrics_run(mod, obs) for mod, obs in
                 ((ref_metrics, ref_obs), (port_metrics, port_obs)))
    assert port[0] == ref[0]
    assert port[3] == ref[3]
    assert port[0]["promotion_wait_p99_s"] > 0.0
    assert port[1] == ref[1]
    # the promotion wait's HELP text says that the port's wait runs to
    # the install's completion (the reference's times its dispatches)
    help_line = "# HELP ptpu_kv_promotion_wait_seconds"
    assert [ln for ln in port[2].splitlines()
            if not ln.startswith(help_line)] \
        == [ln for ln in ref[2].splitlines()
            if not ln.startswith(help_line)]
    assert "ptpu_kv_promotion_wait_seconds_count 2" in port[2]
    assert "ptpu_serving_decode_stall_seconds_count 3" in port[2]
    assert math.isclose(port[0]["spec_draft_s"], 0.066)
