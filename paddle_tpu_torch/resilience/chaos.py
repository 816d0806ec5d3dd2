"""Seeded chaos soak of the serving engine: randomized fault schedules,
checked against the conservation laws after every episode.

Counterpart of ``paddle_tpu/resilience/chaos.py``'s serving episode
(``FaultArm``, ``EpisodeResult``, the prompt pool, ``_sample_arms``,
``run_serving_episode``, ``_serving_watchtower``, ``_serving_result``,
``SERVING_SWEEP``, ``run_episode(kind="serving")``); a copy, not an
import. The training, front-door and cluster episodes wait for the
slices that port their subjects.

One episode = one seed. The seed deterministically samples a fault
schedule over the serving fault points and a workload (Poisson arrivals
over a fixed prompt pool, deadlines, cancels, an early shutdown), drives
the engine through it with ``recover()`` after every failed step and a
final ``drain()``, possibly itself under fire, and then audits every
law of ``resilience/invariants.py``: exactly-once delivery (the
engine's ``auditor``), greedy tokens a prefix of an uninjected run's,
and no leaked slot, queue entry, PREFILLING slot, staged promotion,
page, reservation or tier pin. A red episode replays from its seed
alone (virtual clock, seeded RNGs).

Every rng stream is drawn as the reference draws it, in the same order
and under the same conditions, so a seed's fault schedule and workload
are the reference's ``mesh_flavor="local"`` episode's bit for bit:
stream 1 (the seed: slots, donation, speculation, pool budget, the
workload, the core arms, shutdown), 2 (the mesh flavour), 3 (chunked
prefill), 4 (the KV host tier and its duty cycle), 5 (the cross-host KV
wire), 6 (draft-model, sampled and tuned speculation) and 7 (the
chunk-budget controller). Two draws change nothing here: the flavour is
always ``"local"`` (``"tp"`` and ``"disagg"`` raise: the mesh comes with
the multi-GPU serving slice), and the ``donate`` draw is made but the
port always takes the donated path (its pools are written in place, so
every failed step breaks the engine until ``recover()``; the reference
on the CPU retries a failed undonated step instead, and ``drain()``
there retries up to three times where the port's cancels the rest).

The models are tiny Llamas (1 layer, width 32, 32 positions): the
target and an independently seeded "other" draft twin, drawn by the
port's initializers on the card unless :func:`set_serving_models` gives
others (the tests pass copies of the reference's, converted, and CPU
models).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import faults
from .invariants import (ConservationLedger, engine_leak_violations,
                         page_leak_violations, token_prefix_violations)

__all__ = ["FaultArm", "EpisodeResult", "SERVING_SWEEP", "CONTROL_SWEEP",
           "SERVING_LATER", "set_serving_models", "run_serving_episode",
           "run_episode"]

# the reference's sweep partition, as far as the port has episodes: the
# serving episode samples every SERVING_SWEEP point but the mesh-only
# ones (SERVING_LATER, which need the multi-GPU serving slice); of
# CONTROL_SWEEP it arms control.chunk, and the other three control
# points belong to the front-door episodes of the serving fleet
SERVING_SWEEP = ("serving.step.decode", "serving.decode.verify",
                 "serving.decode.sharded",
                 "serving.step.prefill", "serving.prefill.paged",
                 "serving.prefill.chunk", "serving.kv.handoff",
                 "serving.kv.demote", "serving.kv.promote",
                 "serving.spec.draft", "serving.spec.resample")
SERVING_LATER = {"serving.decode.sharded": "multi-GPU serving slice",
                 "serving.kv.handoff": "multi-GPU serving slice"}
CONTROL_SWEEP = ("control.shed", "control.chunk",
                 "control.affinity", "control.scale")


@dataclasses.dataclass
class FaultArm:
    """One sampled injection: fail ``times`` times after ``after`` hits
    at ``point`` (count-based, so every episode terminates)."""
    point: str
    times: int
    after: int

    def arm(self) -> None:
        faults.inject(self.point, times=self.times, after=self.after)


@dataclasses.dataclass
class EpisodeResult:
    seed: int
    kind: str                     # "serving"
    violations: List[str]         # empty = every law held
    schedule: List[FaultArm]      # what the seed armed (the reproducer)
    fired: Dict[str, int]         # faults that actually fired
    stats: Dict[str, object]

    @property
    def ok(self) -> bool:
        return not self.violations


# the fixed prompt pool and its uninjected outputs, cached per process:
# greedy decoding is prefix-stable, so any episode request over pool
# prompt i must emit a prefix of _refs[i]
_MAX_LEN = 32
_MIN_BUCKET = 8
_REF_HORIZON = 8
_models: Dict[str, object] = {}
_refs: Optional[List[List[int]]] = None
_pool: Optional[List[np.ndarray]] = None


def _prompt_pool() -> List[np.ndarray]:
    global _pool
    if _pool is None:
        rng = np.random.RandomState(1234)
        _pool = [rng.randint(1, 96, (int(n),)).astype(np.int64)
                 for n in (3, 4, 5, 7, 9, 12)]
        # shared-prefix prompts (page_size 8): one full-page hit on the
        # 12-token prompt's first page, and one mid-page hit (a COW), so
        # mid-prefill faults land on shared-prefix admissions too
        base = _pool[5]
        _pool.append(np.concatenate(
            [base[:8], rng.randint(1, 96, (3,))]).astype(np.int64))
        _pool.append(np.concatenate(
            [base[:6], rng.randint(1, 96, (1,))]).astype(np.int64))
        # repetitive prompts: the n-gram proposer finds matches here
        pat = rng.randint(1, 96, (3,)).astype(np.int64)
        _pool.append(np.tile(pat, 4))                    # period 3
        _pool.append(np.full((10,), int(rng.randint(1, 96)),
                             np.int64))                  # period 1
    return _pool


def _tiny_llama(seed: int, device: str):
    import torch
    from ..models.llama import LlamaForCausalLM, llama_tiny_config
    cfg = llama_tiny_config(num_hidden_layers=1, hidden_size=32,
                            intermediate_size=64, num_attention_heads=2,
                            max_position_embeddings=_MAX_LEN)
    gen = torch.Generator(device=device).manual_seed(seed)
    return LlamaForCausalLM(cfg, device=device, generator=gen).eval()


def set_serving_models(model=None, draft_model=None,
                       device: str = "cuda") -> None:
    """The episode's target model and its independently seeded "other"
    draft twin (the "same" draft is the target itself). None draws a
    tiny Llama on ``device`` from seed 0 (target) or 7 (twin). The
    cached uninjected outputs are recomputed on the next episode."""
    global _refs
    _models["target"] = model if model is not None \
        else _tiny_llama(0, device)
    _models["other"] = draft_model if draft_model is not None \
        else _tiny_llama(7, device)
    _refs = None


def _serving_model():
    if "target" not in _models:
        set_serving_models()
    return _models["target"]


def _draft_serving_model(variant: str):
    """``"same"``: the target itself (the oracle draft, every proposal
    accepted); ``"other"``: the independently seeded twin (disagreeing
    drafts, the rejection paths)."""
    _serving_model()
    return _models["target"] if variant == "same" else _models["other"]


def _reference_outputs() -> List[List[int]]:
    """Uninjected greedy run of every pool prompt: the token-identity
    baseline of every episode."""
    global _refs
    if _refs is None:
        from ..observability import FlightRecorder, MetricRegistry
        from ..serving import ServingEngine
        faults.clear()
        eng = ServingEngine(_serving_model(), max_slots=2,
                            max_len=_MAX_LEN, min_bucket=_MIN_BUCKET,
                            registry=MetricRegistry(),
                            flight_recorder=FlightRecorder(capacity=4))
        reqs = [eng.submit(p, max_new_tokens=_REF_HORIZON)
                for p in _prompt_pool()]
        eng.run()
        _refs = [list(r.out_tokens) for r in reqs]
    return _refs


def _sample_arms(rng, specs) -> List[FaultArm]:
    """``specs``: (point, probability, times_range, after_range)."""
    arms = []
    for point, prob, (t0, t1), (a0, a1) in specs:
        if rng.random() < prob:
            arms.append(FaultArm(point, times=int(rng.randint(t0, t1)),
                                 after=int(rng.randint(a0, a1))))
    return arms


def run_serving_episode(seed: int, max_iters: int = 300,
                        mesh_flavor: Optional[str] = None,
                        watchtower: bool = False,
                        arm_faults: bool = True) -> EpisodeResult:
    """One seeded serving episode (reference :246-693): Poisson arrivals
    over the prompt pool with sampled deadlines and cancels, prefill,
    decode, verify, draft, resample, chunk and tier faults, ``recover()``
    after every failed step, and a final ``drain()``, possibly itself
    under fire. Every law is audited at the end.

    ``mesh_flavor``: None or ``"local"`` (single GPU); ``"tp"`` and
    ``"disagg"`` raise ``NotImplementedError`` (the multi-GPU serving
    slice). The stream-2 draw that samples it in the reference is made
    all the same. ``watchtower=True`` attaches a watchtower to the
    episode's registry and virtual clock (polled every iteration,
    flushed at quiesce) and reports its incidents in the stats.
    ``arm_faults=False`` runs the SAME seed (every draw made, the
    schedule built, the workload identical) with no arm armed: the clean
    band the watchtower's false-positive floor is certified on."""
    if mesh_flavor not in (None, "local"):
        raise NotImplementedError(
            f"mesh_flavor={mesh_flavor!r} comes with the multi-GPU "
            f"serving slice of the port")
    from ..observability import FlightRecorder, MetricRegistry
    from ..serving import ServingEngine

    model = _serving_model()
    refs = _reference_outputs()
    pool = _prompt_pool()
    faults.clear()
    faults.reset_counts()
    rng = np.random.RandomState(seed)
    ledger = ConservationLedger()
    clock = {"t": 0.0}
    max_slots = int(rng.randint(1, 4))
    # drawn as the reference draws it; the port always takes the donated
    # path (module docstring)
    donate = bool(rng.randint(0, 2))
    speculative = bool(rng.randint(0, 2))
    num_pages = int(rng.randint(_MAX_LEN // 8 + 1,
                                max_slots * (_MAX_LEN // 8) + 2))
    spec_kw = {"speculative": True, "spec_k": 4} if speculative else {}
    # stream 2: the mesh flavour (always "local" here)
    rng2 = np.random.RandomState(770000 + seed)
    rng2.random()
    mesh_flavor = "local"
    # stream 3: chunked prefill
    rng3 = np.random.RandomState(880000 + seed)
    prefill_chunk = [None, None, None, 8, 16][int(rng3.randint(0, 5))]
    chunk_kw = {} if prefill_chunk is None \
        else {"prefill_chunk": prefill_chunk,
              "admission_lookahead": int(rng3.randint(0, 3))}
    # stream 4: the KV host tier (host RAM only), its capacity, and the
    # device pool clamped near the one-request floor so the tier really
    # demotes and promotes
    rng4 = np.random.RandomState(990000 + seed)
    tiered_draw = rng4.random() < 0.45
    tier_cap = int(rng4.randint(2, 16))
    tier_unbounded = rng4.random() < 0.35
    tier_pages = int(rng4.randint(_MAX_LEN // 8 + 1, _MAX_LEN // 8 + 4))
    tier_kw = {}
    if tiered_draw and mesh_flavor == "local":
        tier_kw = {"kv_host_tier": True,
                   "host_tier_pages": None if tier_unbounded
                   else tier_cap}
        num_pages = min(num_pages, tier_pages)
    # stream 5: the cross-host KV wire (disaggregated episodes only, so
    # drawn and never applied here)
    rng5 = np.random.RandomState(1100000 + seed)
    rng5.random()
    rng5.random()
    rng5.randint(1, 3)
    rng5.randint(4, 7)
    rng5.randint(0, 6)
    # stream 6: draft-model proposer, sampled acceptance, the tuner
    rng6 = np.random.RandomState(1210000 + seed)
    r_draftp = rng6.random()
    draft_other = rng6.random() < 0.5
    r_sampled = rng6.random()
    r_tune = rng6.random()
    sampled_flags = rng6.random(16) < 0.4   # per-submit-order flags
    r_arm_draft, t_arm_draft, a_arm_draft = (rng6.random(),
                                             int(rng6.randint(1, 3)),
                                             int(rng6.randint(0, 8)))
    r_arm_res, t_arm_res, a_arm_res = (rng6.random(),
                                       int(rng6.randint(1, 3)),
                                       int(rng6.randint(0, 6)))
    spec_sampled_on = False
    if speculative:
        if r_draftp < 0.5:
            spec_kw["spec_proposer"] = "draft"
            spec_kw["draft_model"] = _draft_serving_model(
                "other" if draft_other else "same")
        if r_sampled < 0.35:
            spec_sampled_on = True
            spec_kw["spec_sampled"] = True
        if r_tune < 0.4:
            spec_kw["spec_tune"] = True
    # stream 7: the chunk-budget controller and its admission burst
    rng7 = np.random.RandomState(1320000 + seed)
    ctl_draw = rng7.random() < 0.65
    ctl_raise = float(rng7.randint(2, 5))
    r_arm_chunk, t_arm_chunk, a_arm_chunk = (rng7.random(),
                                             int(rng7.randint(1, 3)),
                                             int(rng7.randint(0, 4)))
    ctl_burst_t0 = float(rng7.randint(1, 3))
    n_ctl_burst = int(rng7.randint(4, 8))
    ctl_burst_dt = rng7.exponential(0.3, 8)
    ctl_burst_idx = rng7.randint(0, len(pool), 8)
    ctl_burst_new = rng7.randint(2, 6, 8)
    registry = MetricRegistry()
    chunk_control = None
    if ctl_draw and prefill_chunk is not None:
        from ..serving.control import Actuator, ChunkBudgetController
        chunk_control = ChunkBudgetController(
            raise_depth=ctl_raise, lower_depth=0.5, dwell=2,
            mults=(1, 2, 4),
            actuator=Actuator(window=8, registry=registry),
            registry=registry)
        chunk_kw["chunk_control"] = chunk_control
    eng = ServingEngine(model, max_slots=max_slots, max_len=_MAX_LEN,
                        min_bucket=_MIN_BUCKET,
                        page_size=8, num_pages=num_pages,
                        time_fn=lambda: clock["t"],
                        registry=registry,
                        flight_recorder=FlightRecorder(capacity=8),
                        auditor=ledger, **spec_kw, **chunk_kw, **tier_kw)
    wt = None
    if watchtower:
        wt = _serving_watchtower(registry, clock)
        wt.attach_engine(eng)

    n_req = int(rng.randint(4, 9))
    plan = []                 # (arrival_t, pool_idx, max_new, deadline)
    t = 0.0
    for _ in range(n_req):
        t += float(rng.exponential(1.5))
        # 1-token requests finish AT prefill: the admission-batch
        # finisher a later prefill fault in the same step strands
        max_new = 1 if rng.random() < 0.25 \
            else int(rng.randint(2, _REF_HORIZON + 1))
        plan.append((t, int(rng.randint(0, len(pool))), max_new,
                     float(rng.randint(2, 18))
                     if rng.random() < 0.45 else None))
    # the tier's demote/promote duty cycle (drawn unconditionally from
    # stream 4, applied only with the tier): shared-prefix requests
    # around the pool[5] radix family alternating with disjoint ones
    n_tier_req = int(rng4.randint(4, 8))
    t_tier = t
    tier_plan = []
    for i in range(n_tier_req):
        t_tier += float(rng4.exponential(1.5))
        idx = (5, 6)[int(rng4.randint(0, 2))] if i % 2 == 0 \
            else (4, 8, 9)[int(rng4.randint(0, 3))]
        mn = min(int(rng4.randint(2, _REF_HORIZON + 1)), 4)
        if i < 5:
            tier_plan.append((t_tier, idx, mn, None))
    if tier_kw:
        plan.extend(tier_plan)
    if chunk_control is not None:
        tb = ctl_burst_t0
        for k in range(n_ctl_burst):
            tb += float(ctl_burst_dt[k])
            plan.append((tb, int(ctl_burst_idx[k]),
                         int(ctl_burst_new[k]), None))
        plan.sort(key=lambda e: e[0])
    cancels = []              # (submit order, loop iteration)
    if rng.random() < 0.4:
        cancels.append((int(rng.randint(0, n_req)),
                        int(rng.randint(1, 12))))
    schedule = _sample_arms(rng, [
        ("serving.step.decode", 0.6, (1, 3), (0, 8)),
        ("serving.decode.verify", 0.5, (1, 3), (0, 8)),
        ("serving.step.prefill", 0.5, (1, 3), (0, 8)),
        ("serving.prefill.paged", 0.4, (1, 3), (0, 8)),
    ])
    # (the reference's mesh-only arms draw from stream 2 only on mesh
    # flavours, so a local episode draws nothing more there)
    if prefill_chunk is not None and rng3.random() < 0.55:
        schedule.append(FaultArm("serving.prefill.chunk",
                                 times=int(rng3.randint(1, 3)),
                                 after=int(rng3.randint(0, 6))))
    if chunk_control is not None and r_arm_chunk < 0.55:
        schedule.append(FaultArm("control.chunk",
                                 times=t_arm_chunk, after=a_arm_chunk))
    # tier arms: demote fires before either tier mutates; promote with
    # the dst pages claimed and the request staged
    r_demote, t_demote, a_demote = (rng4.random(),
                                    int(rng4.randint(1, 3)),
                                    int(rng4.randint(0, 7)))
    r_promote, t_promote, a_promote = (rng4.random(),
                                       int(rng4.randint(1, 3)),
                                       int(rng4.randint(0, 5)))
    if tier_kw:
        if r_demote < 0.5:
            schedule.append(FaultArm("serving.kv.demote",
                                     times=t_demote, after=a_demote))
        if r_promote < 0.5:
            schedule.append(FaultArm("serving.kv.promote",
                                     times=t_promote, after=a_promote))
    if speculative and r_arm_draft < 0.55:
        schedule.append(FaultArm("serving.spec.draft",
                                 times=t_arm_draft, after=a_arm_draft))
    if speculative and spec_sampled_on and r_arm_res < 0.5:
        schedule.append(FaultArm("serving.spec.resample",
                                 times=t_arm_res, after=a_arm_res))
    # shutdown chaos: half the episodes drain() mid-trace with the queue
    # and slots still loaded, some with one more decode fault armed
    # right before the drain
    shutdown_iter = int(rng.randint(2, 10)) \
        if rng.random() < 0.5 else None
    drain_arm = None
    if rng.random() < 0.5:
        drain_arm = FaultArm("serving.step.decode", times=1,
                             after=int(rng.randint(0, 3)))
        schedule = schedule + [drain_arm]
    if arm_faults:
        for arm in schedule:
            if arm is not drain_arm:
                arm.arm()

    violations: List[str] = []
    submitted: List[Tuple[object, int]] = []

    def _submit(pi, mn, dl):
        # sampled-acceptance episodes mark some requests (by submit
        # order) temperature > 0 with a pinned per-request seed
        samp = None
        order = len(submitted)
        if spec_sampled_on and order < len(sampled_flags) \
                and sampled_flags[order]:
            from ..serving.sampling import SamplingParams
            samp = SamplingParams(temperature=0.8, top_k=8,
                                  seed=13579 + 1000 * seed + order)
        submitted.append((eng.submit(pool[pi], max_new_tokens=mn,
                                     deadline_s=dl, sampling=samp), pi))
    recoveries = 0
    steps_ok = 0
    i = 0
    iters = 0
    try:
        while i < len(plan) or eng.has_work():
            iters += 1
            if iters > max_iters:
                violations.append(
                    f"episode did not quiesce within {max_iters} "
                    f"iterations")
                break
            if shutdown_iter is not None and iters >= shutdown_iter:
                # early shutdown: submit what the trace still owes, so
                # the drain inherits a loaded queue
                while i < len(plan):
                    _, pi, mn, dl = plan[i]
                    _submit(pi, mn, dl)
                    i += 1
                break
            clock["t"] += 1.0
            while i < len(plan) and plan[i][0] <= clock["t"]:
                _, pi, mn, dl = plan[i]
                _submit(pi, mn, dl)
                i += 1
            for order, at_iter in cancels:
                if at_iter == iters and order < len(submitted):
                    eng.cancel(submitted[order][0])
            if wt is not None:
                wt.poll()
            if not eng.has_work():
                continue
            try:
                eng.step()
                steps_ok += 1
            except Exception:
                # every failed step breaks the engine: recover(), which
                # may itself fail and is simply retried
                attempts = 0
                while eng._broken:
                    attempts += 1
                    if attempts > 10:
                        violations.append(
                            "recover() did not converge within 10 "
                            "attempts")
                        return _serving_result(
                            seed, violations, schedule, ledger,
                            submitted, refs, eng, recoveries, steps_ok,
                            donate, wt)
                    try:
                        eng.recover()
                        recoveries += 1
                    except Exception:
                        continue
        if drain_arm is not None and arm_faults:
            drain_arm.arm()
        eng.drain()
    except Exception as e:  # noqa: BLE001 — any escape breaks the
        violations.append(  # "drain()/step() never strand work" law
            f"episode escaped with {type(e).__name__}: {e}")
    return _serving_result(seed, violations, schedule, ledger, submitted,
                           refs, eng, recoveries, steps_ok, donate, wt)


def _serving_watchtower(registry, clock):
    """The watchtower the serving chaos band certifies (reference
    :695-723): burn objectives in VIRTUAL seconds with thresholds far
    above what a clean episode produces (a clean band must raise zero
    incidents), the orphan detector on, and the wall-clock-shaped
    detectors (stall, heartbeat, EWMA streams) off: an
    iteration-granular virtual clock freeze-frames between polls, which
    they would misread as outages."""
    from ..observability.watchtower import SLOObjective, Watchtower
    objectives = (
        SLOObjective("ttft_p50_virtual", threshold_s=120.0,
                     objective=0.5,
                     family="ptpu_serving_ttft_seconds",
                     phase="queue", fast_window_s=30.0,
                     slow_window_s=300.0),
        SLOObjective("queue_wait_p50_virtual", threshold_s=120.0,
                     objective=0.5,
                     family="ptpu_serving_queue_wait_seconds",
                     phase="queue", fast_window_s=30.0,
                     slow_window_s=300.0),
    )
    return Watchtower(registry=registry, objectives=objectives,
                      time_fn=lambda: clock["t"],
                      eval_interval_s=2.0, dedup_window_s=1e9,
                      stall_after_s=None, heartbeat_max_age_s=None,
                      anomaly_streams=False)


def _serving_result(seed, violations, schedule, ledger, submitted, refs,
                    eng, recoveries, steps_ok, donate,
                    wt=None) -> EpisodeResult:
    if wt is not None:
        # two forced evaluations at quiesce: the orphan detector needs
        # two consecutive sightings
        wt.flush()
        wt.flush()
    fired = faults.fired()
    faults.clear()
    violations = list(violations)
    violations += ledger.violations()
    violations += engine_leak_violations(eng)
    violations += page_leak_violations(eng)
    # token identity is a GREEDY law: sampled requests draw from their
    # own rng streams and stay in the conservation and leak audits only
    violations += token_prefix_violations(
        (req, refs[pi]) for req, pi in submitted
        if req.sampling.temperature <= 0)
    spec = eng._spec if eng.speculative else {}
    return EpisodeResult(
        seed=seed, kind="serving", violations=violations,
        schedule=schedule, fired=fired,
        stats={"requests": len(submitted), "recoveries": recoveries,
               "steps": steps_ok,
               # the port always takes the donated path; the draw is kept
               "donate": True, "donate_drawn": donate,
               "mesh": "local", "tp": 0,
               "speculative": eng.speculative,
               "spec_emitted": spec.get("emitted", 0),
               "spec_accepted_drafts": spec.get("accepted_draft_tokens", 0),
               "spec_proposer": getattr(eng, "spec_proposer", None),
               "spec_sampled": getattr(eng, "spec_sampled", False),
               "spec_tuned": getattr(eng, "_tuner", None) is not None,
               "spec_draft_faults": spec.get("draft_faults", 0),
               "spec_resamples": spec.get("resamples", 0),
               "prefill_chunk": eng.prefill_chunk,
               "chunk_ctl": eng.chunk_control is not None,
               "chunk_adaptations": (eng.chunk_control.adaptations
                                     if eng.chunk_control is not None
                                     else 0),
               "max_slots": eng.max_slots,
               "num_pages": eng.cache.num_pages,
               "prefix_hit_tokens": eng.cache.prefix_hit_tokens,
               "cow_copies": eng.cache.cow_copies,
               "kv_tiered": eng._kv_tier is not None,
               "demotions": eng.cache.demotions,
               "promotions": eng.cache.promotions,
               "kv_wired": False, "wire_handoffs": 0,
               "incidents": 0 if wt is None else len(wt.incidents()),
               "incident_kinds": sorted(
                   {(i.kind, i.phase) for i in wt.incidents()})
               if wt is not None else []})


def run_episode(seed: int, kind: str,
                workdir: Optional[str] = None) -> EpisodeResult:
    """Dispatch one episode. Only ``"serving"`` is ported; the
    training, front-door and cluster episodes raise
    ``NotImplementedError`` naming their slice."""
    del workdir
    if kind == "serving":
        return run_serving_episode(seed)
    later = {"training": "training-resilience slice",
             "frontdoor": "serving fleet slice",
             "cluster": "serving fleet slice"}
    if kind in later:
        raise NotImplementedError(
            f"{kind} chaos episodes come with the {later[kind]} of the "
            f"port")
    raise ValueError(f"unknown episode kind {kind!r}")
