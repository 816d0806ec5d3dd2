"""paddle_tpu_torch's serving chaos soak (resilience/chaos.py) against the
reference's (paddle_tpu/resilience/chaos.py), mirroring the serving half
of tests/test_chaos.py.

The episode's models are the reference's own (its one-layer tiny Llama
from seed 0 and the "other" draft twin from seed 7), carried across by
models/convert.py; f32 on one torch thread, CPU pools. Every port
episode over SERVING_SEEDS must hold every law; the band must really
speculate, chunk, tier and draft (the reference's floors); a seed
replays identically; the watchtower's clean band raises nothing; each
pinned seed goes red when the bug class it guards is put back. Two
seeds run through the reference's ``run_serving_episode(seed,
mesh_flavor="local")`` as well, and the port's must draw the same
schedule, fire the same faults and end every request in the same state
with the same tokens (exact). Those two seeds are ones where the
reference draws its donated-pool path and no fault lands inside
``drain()``: elsewhere the flavours legitimately part (the reference's
undonated CPU path retries a failed step and its ``drain()`` retries
three times, where the port recovers and its ``drain()`` cancels).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models.convert import llama_from_jax_state
from paddle_tpu_torch.resilience import chaos, faults


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


def _convert(model):
    state = {n: np.asarray(t._data) for n, t in model.state_dict().items()}
    cfg = port_llama.llama_tiny_config(
        num_hidden_layers=1, hidden_size=32, intermediate_size=64,
        num_attention_heads=2, max_position_embeddings=32)
    return llama_from_jax_state(state, cfg, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _models():
    from paddle_tpu.resilience import chaos as ref_chaos
    chaos.set_serving_models(_convert(ref_chaos._serving_model()),
                             _convert(ref_chaos._draft_serving_model(
                                 "other")))
    yield
    chaos._models.clear()
    chaos._refs = None


def test_sweep_covers_the_ported_fault_points():
    """Every fault point the port wires is swept by the serving episode
    or (the control points) by the reference's sweep partition; the
    mesh-only points are named as later and are not wired yet."""
    from paddle_tpu.resilience import chaos as ref_chaos
    assert chaos.SERVING_SWEEP == ref_chaos.SERVING_SWEEP
    assert chaos.CONTROL_SWEEP == ref_chaos.CONTROL_SWEEP
    later = set(chaos.SERVING_LATER)
    assert later == {"serving.decode.sharded", "serving.kv.handoff"}
    assert not later & set(faults.KNOWN_POINTS)
    assert (set(chaos.SERVING_SWEEP) - later) | set(chaos.CONTROL_SWEEP) \
        == set(faults.KNOWN_POINTS)


def test_reference_outputs_match():
    """The uninjected baseline every episode is audited against: the
    port's engine gives the reference engine's tokens on the pool."""
    from paddle_tpu.resilience import chaos as ref_chaos
    assert chaos._reference_outputs() == ref_chaos._reference_outputs()


SERVING_SEEDS = list(range(0, 13))
_tally = {"episodes": 0, "speculative": 0, "accepted_drafts": 0,
          "verify_kills": 0, "chunked": 0, "chunk_kills": 0, "tiered": 0,
          "demotions": 0, "promotions": 0, "draft_proposed": 0,
          "spec_sampled": 0, "spec_tuned": 0, "draft_kills": 0,
          "draft_faults": 0}


@pytest.mark.parametrize("seed", SERVING_SEEDS)
def test_serving_episode_matrix(seed):
    res = chaos.run_serving_episode(seed)
    assert res.ok, "\n".join(res.violations)
    assert res.stats["requests"] >= 1 and res.stats["mesh"] == "local"
    st, fired = res.stats, res.fired
    for key, val in (
            ("speculative", st["speculative"]),
            ("accepted_drafts", st["spec_accepted_drafts"]),
            ("verify_kills", fired.get("serving.decode.verify", 0)),
            ("chunked", bool(st["prefill_chunk"])),
            ("chunk_kills", fired.get("serving.prefill.chunk", 0)),
            ("tiered", st["kv_tiered"]),
            ("demotions", st["demotions"]),
            ("promotions", st["promotions"]),
            ("draft_proposed", st["spec_proposer"] == "draft"),
            ("spec_sampled", st["spec_sampled"]),
            ("spec_tuned", st["spec_tuned"]),
            ("draft_kills", fired.get("serving.spec.draft", 0)),
            ("draft_faults", st["spec_draft_faults"])):
        _tally[key] += int(val)
    _tally["episodes"] += 1


def _band_ran():
    if _tally["episodes"] < len(SERVING_SEEDS):
        pytest.skip("full serving matrix did not run")


def test_serving_matrix_actually_speculates():
    _band_ran()
    assert _tally["speculative"] >= 4, _tally
    assert _tally["accepted_drafts"] >= 3, _tally
    assert _tally["verify_kills"] >= 2, _tally


def test_serving_matrix_actually_chunks():
    _band_ran()
    assert _tally["chunked"] >= 3, _tally
    assert _tally["chunk_kills"] >= 1, _tally


def test_serving_matrix_actually_tiers():
    _band_ran()
    assert _tally["tiered"] >= 3, _tally
    assert _tally["demotions"] >= 2, _tally
    assert _tally["promotions"] >= 1, _tally


def test_serving_matrix_actually_drafts():
    _band_ran()
    assert _tally["draft_proposed"] >= 4, _tally
    assert _tally["spec_sampled"] >= 1, _tally
    assert _tally["spec_tuned"] >= 2, _tally
    assert _tally["draft_kills"] >= 1, _tally
    assert _tally["draft_faults"] >= 1, _tally


def test_episodes_are_deterministic():
    a = chaos.run_serving_episode(3)
    b = chaos.run_serving_episode(3)
    assert [(x.point, x.times, x.after) for x in a.schedule] \
        == [(x.point, x.times, x.after) for x in b.schedule]
    assert a.fired == b.fired and a.violations == b.violations
    assert a.stats == b.stats


WATCHTOWER_CLEAN_SEEDS = list(range(25))


@pytest.mark.parametrize("seed", WATCHTOWER_CLEAN_SEEDS)
def test_watchtower_clean_band_raises_zero_incidents(seed):
    res = chaos.run_serving_episode(seed, watchtower=True,
                                    arm_faults=False)
    assert res.ok, "\n".join(res.violations)
    assert res.fired == {}
    assert res.stats["incidents"] == 0, res.stats["incident_kinds"]


def test_mesh_flavours_and_other_kinds_are_later():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        chaos.run_serving_episode(0, mesh_flavor="tp")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        chaos.run_serving_episode(0, mesh_flavor="disagg")
    with pytest.raises(NotImplementedError, match="training"):
        chaos.run_episode(100, "training", workdir="/nonexistent")
    with pytest.raises(ValueError, match="unknown"):
        chaos.run_episode(0, "nope")
    assert chaos.run_episode(2, "serving").ok


# -- against the reference's episodes ---------------------------------------

@pytest.mark.parametrize("seed", [8, 12])
def test_episode_matches_reference_local_flavour(seed, monkeypatch):
    """Seeds 8 and 12 run the tiered engine (12 also a demote kill,
    draft-model speculation and chunk 16; 8 an n-gram verify kill and a
    decode kill): the same schedule, the same faults fired, and every
    request's terminal state and tokens equal to the reference's."""
    from paddle_tpu.resilience import chaos as ref_chaos
    from paddle_tpu.serving import ServingEngine as JaxServingEngine
    from paddle_tpu_torch.serving import ServingEngine

    def capture(cls):
        got, orig = [], cls.submit

        def submit(self, *a, **kw):
            r = orig(self, *a, **kw)
            got.append(r)
            return r
        monkeypatch.setattr(cls, "submit", submit)
        return got
    ref_reqs, port_reqs = capture(JaxServingEngine), capture(ServingEngine)
    ref = ref_chaos.run_serving_episode(seed, mesh_flavor="local")
    port = chaos.run_serving_episode(seed, mesh_flavor="local")
    assert ref.ok and port.ok, port.violations
    assert ref.stats["donate"] is True and port.stats["kv_tiered"]
    assert [(a.point, a.times, a.after) for a in port.schedule] \
        == [(a.point, a.times, a.after) for a in ref.schedule]
    assert port.fired == ref.fired
    assert [(r.rid, r.finish_reason, list(r.out_tokens))
            for r in port_reqs] \
        == [(r.rid, r.finish_reason, list(r.out_tokens)) for r in ref_reqs]
    # (the tier counters are not compared: the port's recover() parks
    # the dying index's device pages in the tier, so it promotes where
    # the reference's rebuilt pool re-prefills)
    for key in ("requests", "speculative", "spec_proposer", "prefill_chunk",
                "kv_tiered", "max_slots", "num_pages",
                "spec_accepted_drafts"):
        assert port.stats[key] == ref.stats[key], key


# -- pinned seeds: the harness catches the bug classes ----------------------

def test_pinned_seed_catches_lost_finished_on_failed_step(monkeypatch):
    """A request that reached a terminal state inside a step that then
    failed must survive the raise (``_undelivered``): with it dropped,
    the ledger goes red with LOST on seed 17; the real code is green."""
    from paddle_tpu_torch.serving import ServingEngine
    orig_step = ServingEngine.step

    def lossy_step(self):
        n = len(self._undelivered)
        try:
            return orig_step(self)
        except Exception:
            del self._undelivered[n:]
            raise
    monkeypatch.setattr(ServingEngine, "step", lossy_step)
    red = chaos.run_serving_episode(17)
    assert not red.ok
    assert any("LOST" in v for v in red.violations), red.violations
    monkeypatch.setattr(ServingEngine, "step", orig_step)
    green = chaos.run_serving_episode(17)
    assert green.ok, "\n".join(green.violations)


def test_pinned_seed_catches_leaked_pages_on_aborted_prefill(monkeypatch):
    """A prefill that fails after claiming pages must unwind them: with
    ``abort_sequence`` disabled, seed 15's mid-prefill fault strands
    refcounts and the page audit goes red."""
    from paddle_tpu_torch.serving.slot_cache import PagedKVCache
    orig = PagedKVCache.abort_sequence
    monkeypatch.setattr(PagedKVCache, "abort_sequence",
                        lambda self, slot, req: None)
    red = chaos.run_serving_episode(15)
    assert not red.ok
    assert any("leaked page" in v or "reservation" in v
               for v in red.violations), red.violations
    monkeypatch.setattr(PagedKVCache, "abort_sequence", orig)
    green = chaos.run_serving_episode(15)
    assert green.ok, "\n".join(green.violations)


def test_pinned_seed_catches_swallowed_chunk_fault(monkeypatch):
    """A fault between chunks must unwind the slot AND requeue: with the
    requeue swallowed, seed 1 (chunk 8) loses the request."""
    from paddle_tpu_torch.serving import ServingEngine
    orig = ServingEngine._unwind_chunk

    def dropped(self, slot, req, requeue):
        self._clear_chunk_state(slot, req)
        self.cache.abort_sequence(slot, req)
        self.cache.release(slot)
        req.slot = None
    monkeypatch.setattr(ServingEngine, "_unwind_chunk", dropped)
    red = chaos.run_serving_episode(1)
    assert not red.ok
    assert any("LOST" in v for v in red.violations), red.violations
    monkeypatch.setattr(ServingEngine, "_unwind_chunk", orig)
    green = chaos.run_serving_episode(1)
    assert green.ok, "\n".join(green.violations)
    assert green.stats["prefill_chunk"] == 8
    assert green.fired.get("serving.prefill.chunk", 0) >= 1


# the reference pins 696, where its undonated drain() retries its way to
# the promotion kill; the port's drain() cancels there instead, so the
# port pins 186, a tiered seed whose promote kill fires mid-trace
PINNED_SEED_DROPPED_PROMOTION = 186


def test_pinned_seed_dropped_kv_promotion_goes_lost(monkeypatch):
    """A promotion failure swallowed at the prefill boundary (the
    request staged, its dst pages claimed, then neither served nor
    returned) must show: the ledger goes red with LOST and the
    watchtower names the orphan in the ``kv_promotion`` phase. The real
    unwind (staging popped, pages and pins returned, the request
    requeued) is green on the same seed, with the kill fired and real
    demotions and promotions behind it."""
    from paddle_tpu_torch.resilience.faults import InjectedFault
    from paddle_tpu_torch.serving import ServingEngine
    orig = ServingEngine._prefill

    def swallow(self, slot, req):
        try:
            return orig(self, slot, req)
        except InjectedFault as e:
            if getattr(e, "point", "") != "serving.kv.promote":
                raise
            return
    monkeypatch.setattr(ServingEngine, "_prefill", swallow)
    red = chaos.run_serving_episode(PINNED_SEED_DROPPED_PROMOTION,
                                    watchtower=True)
    assert not red.ok
    assert any("LOST" in v for v in red.violations), red.violations
    assert ("request_orphaned", "kv_promotion") \
        in red.stats["incident_kinds"], red.stats
    monkeypatch.setattr(ServingEngine, "_prefill", orig)
    green = chaos.run_serving_episode(PINNED_SEED_DROPPED_PROMOTION,
                                      watchtower=True)
    assert green.ok, "\n".join(green.violations)
    assert green.fired.get("serving.kv.promote", 0) >= 1
    assert green.stats["incidents"] == 0, green.stats
    assert green.stats["kv_tiered"]
    assert green.stats["demotions"] >= 1
    assert green.stats["promotions"] >= 1
