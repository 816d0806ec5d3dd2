"""paddle_tpu_torch's GPT serving model against the reference's
(paddle_tpu/models/gpt.py ``GPTForCausalLM``, JAX on the CPU), and the
reference's GPT serving laws on the port's engine.

One tiny f32 GPT (vocab 128, hidden 64, 2 layers, 4 heads, max_seq_len
64, as the reference's GPT serving tests use) per module: the reference
model is built with its initializers stubbed to zeros (their jitted
random draws would compile for seconds), given numpy weights from seed 0
and carried to the port by ``gpt_lm_from_jax_state``.

- The conversion: names, the ``[in, out]`` transposes, the tied and the
  untied head; a wrong shape raises.
- ``layer_norm`` bit for bit against the reference's at bf16 (the
  normalized value rounded before the affine).
- The uncached logits within ``atol=rtol=1e-5`` of the reference's.
- The cached forward in every flavour the engine drives (contiguous
  prefill, decode, verify and chunk; paged decode, extend past the
  table, verify, int8 decode) against the reference backbone: hidden
  states of the real tokens within 1e-5, caches within 1e-5 (page 0,
  the trash page nothing reads, aside).
- The engine: greedy and seeded-sampling tokens equal to the reference
  engine's, exactly, contiguous and paged (two reference engines, the
  file's only ones).
- The reference's GPT laws on the port (tests/test_serving_engine.py,
  test_paged_kv.py, test_spec_decode.py, test_spec_v2.py,
  test_serving_chunked.py): the engine against a full-context greedy
  recompute; paged equal to contiguous; int8 KV's 0.9 agreement gate;
  prefix sharing equal to unshared; the speculative identity band and a
  GPT self-draft on both layouts; chunked equal to unchunked over 25
  seeds and to the full-context greedy loop; ``recover()`` after a
  decode fault equal to the fault-free run.
- ``weight_only_int4`` / ``weight_only_int8``: the port's swaps pick the
  reference's layers, codes and scales, and the converted quantized
  GPT's logits lie within 1e-4 of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models import gpt as jax_gpt
from paddle_tpu.nn import initializer as jax_init
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models.convert import gpt_lm_from_jax_state
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn.functional import layer_norm
from paddle_tpu_torch.quantization import (Int4Linear, Int8Linear,
                                           weight_only_int4, weight_only_int8)
from paddle_tpu_torch.resilience import (engine_leak_violations, faults,
                                         page_leak_violations)
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
          max_seq_len=64, dropout=0.0)
H, D = 4, 16
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py: exact CPU numbers need
    # one intra-op thread in a process that also runs XLA
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_model(seed: int = 0, **kw):
    """A reference tiny GPT with numpy weights from ``seed``: linear
    weights at scale 1/sqrt(in), embeddings at 0.5, biases and the
    LayerNorms' offsets at 0.1."""
    def zeros(self, shape, dtype):
        return jnp.zeros(shape, dtype)
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jax_init.XavierNormal, jax_init.XavierUniform,
                    jax_init.Normal, jax_init.Constant, jax_init.Uniform):
            mp.setattr(cls, "__call__", zeros)
        model = jax_gpt.GPTForCausalLM(jax_gpt.GPTConfig(**dict(KW, **kw)))
    rng = np.random.RandomState(seed)
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if "ln" in name and name.endswith("weight"):
            a = 1.0 + rng.normal(0, 0.1, shape)
        elif name.endswith("bias"):
            a = rng.normal(0, 0.1, shape)
        elif "wte" in name or "wpe" in name:
            a = rng.normal(0, 0.5, shape)
        else:
            a = rng.normal(0, 1.0 / np.sqrt(shape[0]), shape)
        t._data = jnp.asarray(a.astype(np.float32))
    model.eval()
    return model


def _np_state(model):
    return {n: np.asarray(t._data) for n, t in model.state_dict().items()}


def _jitted(model, fn):
    """``fn(model, *args)`` as one jitted program of the model's arrays
    (eager reference ops would compile one by one, for seconds);
    Tensors in its output come back as arrays."""
    params, buffers = model.raw_state()

    def unwrap(x):
        return getattr(x, "_data", x)

    @jax.jit
    def run(params, *args):
        with model.bind_state(params, buffers):
            return jax.tree.map(unwrap, fn(model, *args),
                                is_leaf=lambda x: isinstance(x, Tensor))
    return lambda *args: run(params, *args)


def _ref_logits(model, ids):
    return np.asarray(_jitted(model, lambda m, x: m(Tensor(x)))(
        np.asarray(ids, np.int32)))


@pytest.fixture(scope="module")
def pair():
    ref = _ref_model()
    return ref, gpt_lm_from_jax_state(_np_state(ref), GPTConfig(**KW),
                                      device="cpu")


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _prompts(rng, lens, vocab=128):
    return [rng.randint(1, vocab, (n,)).astype(np.int64) for n in lens]


def _full_forward_greedy(model, prompt, new):
    """The reference tests' cache-free anchor: the whole sequence again
    every step, the argmax of the last position."""
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(new):
            logits = model(torch.as_tensor([ids]))[0, -1]
            ids.append(int(logits.argmax()))
    return ids[len(prompt):]


def _serve(model, prompts, news, **kw):
    kw = dict(dict(max_slots=3, max_len=64, min_bucket=8), **kw)
    if kw.get("kv_layout", "paged") == "paged":
        kw.setdefault("page_size", 8)
    eng = ServingEngine(model, **kw)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    eng.run()
    return [r.output_ids for r in reqs], eng


def _quiesced(eng):
    assert engine_leak_violations(eng) == []
    if eng.paged:
        assert page_leak_violations(eng) == []


# -- the model against the reference -------------------------------------

def test_conversion_names_transposes_and_refusals(pair):
    ref, port = pair
    state = _np_state(ref)
    assert set(port.state_dict()) == set(state)
    blk = port.gpt.blocks[1]
    np.testing.assert_array_equal(
        blk.qkv.weight.detach().numpy(), state["gpt.blocks.1.qkv.weight"].T)
    np.testing.assert_array_equal(
        blk.fc2.weight.detach().numpy(), state["gpt.blocks.1.fc2.weight"].T)
    np.testing.assert_array_equal(blk.qkv.bias.detach().numpy(),
                                  state["gpt.blocks.1.qkv.bias"])
    np.testing.assert_array_equal(port.gpt.wpe.weight.detach().numpy(),
                                  state["gpt.wpe.weight"])
    np.testing.assert_array_equal(blk.ln2.weight.detach().numpy(),
                                  state["gpt.blocks.1.ln2.weight"])
    bad = dict(state, **{"gpt.blocks.0.fc1.weight":
                         state["gpt.blocks.0.fc1.weight"].T})
    with pytest.raises(RuntimeError, match="size mismatch"):
        gpt_lm_from_jax_state(bad, GPTConfig(**KW), device="cpu")
    with pytest.raises(RuntimeError, match="Missing"):
        gpt_lm_from_jax_state({k: v for k, v in state.items()
                               if k != "gpt.ln_f.bias"}, GPTConfig(**KW),
                              device="cpu")


def test_untied_head_matches_reference():
    ref = _ref_model(1, tie_embeddings=False)
    state = _np_state(ref)
    port = gpt_lm_from_jax_state(
        state, GPTConfig(**dict(KW, tie_embeddings=False)), device="cpu")
    np.testing.assert_array_equal(port.lm_head.weight.detach().numpy(),
                                  state["lm_head.weight"].T)
    ids = np.random.RandomState(1).randint(0, 128, (2, 9))
    want = _ref_logits(ref, ids)
    with torch.no_grad():
        got = port(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_layer_norm_bf16_bit_for_bit():
    from paddle_tpu.nn import functional as JF
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.normal(1.0, 3.0, (4, 7, 64)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(1, 0.5, 64).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(0, 0.5, 64).astype(np.float32)).bfloat16()

    def j(t):
        return paddle.to_tensor(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    want = np.asarray(JF.layer_norm(j(x), 64, j(w), j(b))._data
                      .astype(jnp.float32))
    got = layer_norm(x, 64, w, b)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the affine in f32 rounds once, elsewhere
    fused = torch.nn.functional.layer_norm(x.float(), (64,), w.float(),
                                           b.float(), 1e-5).bfloat16()
    assert not torch.equal(fused, got)


def test_uncached_logits_match_reference(pair):
    ref, port = pair
    ids = np.random.RandomState(0).randint(0, 128, (2, 23))
    want = _ref_logits(ref, ids)
    with torch.no_grad():
        got = port(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="max_seq_len"):
        port(torch.zeros(1, 65, dtype=torch.long))


# name -> (b, t tokens, real tokens, paged, positions (a list per row or
# a scalar start), wlen per row or None, int8)
PAGE, NPG = 8, 8
FLAVOURS = {
    "contiguous_prefill": (2, 8, 8, False, 0, None, False),
    "contiguous_decode": (3, 1, 1, False, [5, 40, 0], None, False),
    "contiguous_verify": (2, 4, 4, False, [9, 62], [4, 2], False),
    "contiguous_chunk": (1, 8, 5, False, 16, [5], False),
    "paged_decode": (3, 1, 1, True, [13, 63, 0], None, False),
    # a start of 52 with 16 tokens: 4 real, the padding past the table
    "paged_extend_past_table": (1, 16, 4, True, 52, None, False),
    "paged_verify": (2, 4, 4, True, [7, 61], [3, 4], False),
    "paged_decode_int8": (2, 1, 1, True, [21, 3], None, True),
}


def _flavour_caches(case, rng):
    """The same caches as numpy for both sides: random pools (int8 codes
    and scales for int8), pages handed out per row (page 0 the trash
    page), the positions and write lengths."""
    b, t, _, paged, pos, wlen, int8 = case
    L = KW["num_layers"]
    if paged:
        n_pages = 1 + b * NPG
        table = (1 + np.arange(b * NPG)).reshape(b, NPG)
        rng.shuffle(table.reshape(-1))
        if int8:
            pools = [(rng.randint(-127, 128, (n_pages, PAGE, H, D))
                      .astype(np.int8) for _ in range(2)) for _ in range(L)]
            scales = [tuple(rng.uniform(0.001, 0.02, (n_pages, PAGE, H))
                            .astype(np.float32) for _ in range(2))
                      for _ in range(L)]
        else:
            pools = [tuple(rng.normal(0, 1, (n_pages, PAGE, H, D))
                           .astype(np.float32) for _ in range(2))
                     for _ in range(L)]
            scales = [(None, None)] * L
        return [(kp, vp, ks, vs, table.astype(np.int32))
                for (kp, vp), (ks, vs) in zip(pools, scales)]
    return [tuple(rng.normal(0, 1, (b, 64, H, D)).astype(np.float32)
                  for _ in range(2)) for _ in range(L)]


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_cached_forward_flavours_match_reference(pair, flavour):
    """The backbone with caches, each flavour as the engine builds it,
    against the reference backbone given the same arrays: hidden states
    of the real tokens and the caches after the in-place writes."""
    ref, port = pair
    case = FLAVOURS[flavour]
    b, t, real, paged, pos, wlen, int8 = case
    rng = np.random.RandomState(len(flavour))
    ids = rng.randint(0, 128, (b, t))
    arrays = _flavour_caches(case, rng)
    per_row = isinstance(pos, list)
    pos_np = np.asarray(pos, np.int32) if per_row else pos
    tail_np = () if wlen is None else (np.asarray(wlen, np.int32),)

    def jcaches(p, tail):
        # a scalar start stays a Python int: the reference checks it on
        # the host
        return [tuple(None if a is None else jnp.asarray(a) for a in c)
                + (p if per_row else pos,) + tail for c in arrays]

    def tcaches():
        out = []
        for c in arrays:
            arrs = [None if a is None else torch.from_numpy(a.copy())
                    for a in c]
            if paged:
                arrs[4] = arrs[4].long()
            p = torch.from_numpy(pos_np).long() if per_row else pos_np
            out.append(tuple(arrs) + (p,)
                       + tuple(torch.from_numpy(w).long() for w in tail_np))
        return out
    jh, jnew = _jitted(ref, lambda m, ids, p, tail: m.gpt(
        Tensor(ids), caches=jcaches(p, tail)))(
            ids, pos_np if per_row else 0, tail_np)
    with torch.no_grad():
        th, tnew = port.gpt(torch.as_tensor(ids), tcaches())
    np.testing.assert_allclose(th[:, :real].numpy(),
                               np.asarray(jh)[:, :real], **TOL)
    for jc, tc in zip(jnew, tnew):
        n_arr = 4 if paged else 2
        for j, ta in zip(jc[:n_arr], tc[:n_arr]):
            if j is None:
                assert ta is None
                continue
            j, ta = np.asarray(j), ta.numpy()
            if paged:
                j, ta = j[1:], ta[1:]           # the trash page aside
            np.testing.assert_allclose(ta.astype(np.float32),
                                       j.astype(np.float32), **TOL)
        # the new caches end with pos + t in every flavour
        np.testing.assert_array_equal(np.asarray(tc[-1]),
                                      np.asarray(jc[-1]))


# (prompt length, max_new_tokens, temperature, top_k, seed); the last two
# prompts share a 17-token prefix (a full page and a partial one on the
# paged layout: the extend at p = 16 reads the learned positions there)
TRAFFIC = [(5, 6, 0.0, 0, None), (9, 4, 0.8, 20, 7), (13, 7, 0.0, 0, None),
           (3, 5, 1.0, 0, 11), (21, 5, 0.0, 0, None), (20, 6, 0.0, 0, None)]


def _traffic_prompts():
    prompts = _prompts(np.random.RandomState(0), [t[0] for t in TRAFFIC])
    prompts[5][:17] = prompts[4][:17]
    return prompts


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_tokens_match_reference(pair, layout):
    ref, port = pair
    prompts = _traffic_prompts()
    outs = []
    for engine_cls, params_cls, model in (
            (JaxServingEngine, JaxSamplingParams, ref),
            (ServingEngine, SamplingParams, port)):
        kw = {"kv_layout": layout}
        if layout == "paged":
            kw["page_size"] = 8
        eng = engine_cls(model, max_slots=2, max_len=64, min_bucket=16,
                         **kw)
        reqs = []
        for p, (_, n, tmp, k, seed) in zip(prompts, TRAFFIC):
            reqs.append(eng.submit(p, max_new_tokens=n,
                                   sampling=params_cls(temperature=tmp,
                                                       top_k=k, seed=seed)))
            if p is prompts[4]:
                eng.run()       # its pages registered before the sharer
        eng.run()
        outs.append([(r.output_ids, r.finish_reason) for r in reqs])
        if layout == "paged":
            outs[-1].append(eng.paged_stats()["prefix_hit_tokens"])
    assert outs[1] == outs[0]
    if layout == "paged":
        assert outs[1][-1] >= 16                    # the extend ran


# -- the reference's GPT laws on the port ---------------------------------

def test_engine_matches_full_forward_greedy(model):
    """tests/test_serving_engine.py:135: the slot pool's tokens equal a
    full-context greedy recompute."""
    prompts = _prompts(np.random.RandomState(2), [4, 7, 11, 30])
    got, eng = _serve(model, prompts, [5] * 4, kv_layout="contiguous",
                      max_slots=2)
    for p, toks in zip(prompts, got):
        assert toks == _full_forward_greedy(model, p, 5)
    _quiesced(eng)


def test_paged_equals_contiguous_and_int8_gate(model):
    """tests/test_paged_kv.py:161 (paged == contiguous) and :395 (int8
    KV's greedy agreement >= 0.9, int8 pools with f32 scales)."""
    prompts = _prompts(np.random.RandomState(2), [4, 7, 11, 26, 40])
    news = [5, 9, 6, 12, 8]
    contig, _ = _serve(model, prompts, news, kv_layout="contiguous")
    paged, eng = _serve(model, prompts, news)
    assert paged == contig
    _quiesced(eng)
    got, eng8 = _serve(model, prompts, news, kv_dtype="int8")
    pairs = [(a, b) for x, y in zip(got, paged) for a, b in zip(x, y)]
    assert sum(a == b for a, b in pairs) / len(pairs) >= 0.9
    assert eng8.cache.ks[0].dtype == torch.int8
    assert eng8.cache.kss[0].dtype == torch.float32
    _quiesced(eng8)


def test_prefix_sharing_equals_unshared(model):
    """COW prefix sharing (a full page and a mid-page divergence): the
    shared prompts' extends read learned positions at p > 0 and give the
    unshared engine's tokens."""
    rng = np.random.RandomState(3)
    A = rng.randint(1, 128, (19,)).astype(np.int64)
    prompts = [A, np.concatenate([A[:16], [5, 6]]),
               np.concatenate([A[:12], [9]]), np.concatenate([A, [3, 4]])]
    outs = []
    for share in (False, True):
        eng = ServingEngine(model, max_slots=3, max_len=64, min_bucket=8,
                            page_size=8, prefix_sharing=share)
        toks = []
        for p in prompts:
            r = eng.submit(p, max_new_tokens=6)
            eng.run()
            toks.append(r.output_ids)
        outs.append(toks)
        _quiesced(eng)
    assert outs[1] == outs[0]
    st = eng.paged_stats()
    # B and the last prompt match A's two full pages, C one page and 4
    # tokens of the next (the mid-page divergence: a COW copy)
    assert st["prefix_hit_tokens"] == 16 + 12 + 16
    assert st["cow_copies"] >= 1


def _mixed_prompts(rng, n, shared_prefix=None):
    """Half periodic (the traffic self-speculation pays on), half
    random; optionally all after one prefix."""
    out = []
    for _ in range(n):
        L = int(rng.randint(3, 14))
        if rng.random_sample() < 0.5:
            pat = rng.randint(1, 100, (int(rng.randint(1, 4)),))
            p = np.tile(pat, L // len(pat) + 1)[:L]
        else:
            p = rng.randint(1, 100, (L,))
        if shared_prefix is not None:
            p = np.concatenate([shared_prefix, p])
        out.append(p.astype(np.int64))
    return out


@pytest.mark.parametrize("proposer", ["ngram", "self_draft"])
def test_speculative_identity_band_both_layouts(model, proposer):
    """tests/test_spec_decode.py:217 (n-gram) and test_spec_v2.py:239
    (a GPT self-draft): greedy tokens equal k=1's on both layouts, the
    paged band over a shared prefix; nothing leaks."""
    kw = {} if proposer == "ngram" else dict(spec_proposer="draft",
                                             draft_model=model)
    for layout, seeds in (("contiguous", range(4)), ("paged", range(4, 8))):
        lay = dict(kv_layout=layout)
        if layout == "paged":
            lay["page_size"] = 8
        spec = ServingEngine(model, max_slots=3, max_len=64, min_bucket=8,
                             speculative=True, spec_k=4, **lay, **kw)
        base = ServingEngine(model, max_slots=3, max_len=64, min_bucket=8,
                             **lay)
        for seed in seeds:
            rng = np.random.RandomState(seed)
            prefix = rng.randint(1, 100, (9,)).astype(np.int64) \
                if layout == "paged" else None
            prompts = _mixed_prompts(rng, int(rng.randint(2, 5)), prefix)
            news = [int(rng.randint(2, 9)) for _ in prompts]
            rs = [spec.submit(p, n) for p, n in zip(prompts, news)]
            rb = [base.submit(p, n) for p, n in zip(prompts, news)]
            spec.run()
            base.run()
            assert [r.output_ids for r in rs] == [r.output_ids for r in rb], \
                (layout, seed)
        st = spec.spec_stats()
        assert st["draft_faults"] == 0 and st["accepted_draft_tokens"] > 0
        if proposer == "self_draft":
            assert st["draft_hit_rate"] >= 0.95, st
        _quiesced(spec)


def _wave(rng, shared=None):
    """test_serving_chunked.py's wave: 4 ragged prompts (3-39 tokens),
    every other one after a shared prefix."""
    out = []
    for i in range(4):
        p = rng.randint(1, 100, (int(rng.randint(3, 40)),)).astype(np.int64)
        if shared is not None and i % 2 == 0:
            p = np.concatenate([shared, p[:30]]).astype(np.int64)
        out.append(p)
    return out


def _drive(eng, prompts, new=6):
    reqs = [eng.submit(p, new) for p in prompts]
    while eng.has_work():
        eng.step()
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunked_identity_band_25_seeds(model, layout):
    """tests/test_serving_chunked.py:104-110: chunked greedy tokens equal
    the unchunked engine's on 25 seeded waves, chunks 8, 16 and 64 (a
    rotation, all three every fifth seed); paged waves share a prefix."""
    lay = {"kv_layout": layout} if layout == "contiguous" \
        else {"page_size": 8}
    shared = np.arange(1, 11, dtype=np.int64)
    base = ServingEngine(model, max_slots=3, max_len=64, min_bucket=8, **lay)
    chunked = {c: ServingEngine(model, max_slots=3, max_len=64, min_bucket=8,
                                prefill_chunk=c, **lay) for c in (8, 16, 64)}
    for seed in range(25):
        prompts = _wave(np.random.RandomState(1400 + seed),
                        shared if layout == "paged" else None)
        want = _drive(base, prompts)
        for c in ((8, 16, 64) if seed % 5 == 0 else ((8, 16, 64)[seed % 3],)):
            assert _drive(chunked[c], prompts) == want, (layout, seed, c)
    for eng in chunked.values():
        _quiesced(eng)


def test_chunked_matches_full_forward_greedy(model):
    """tests/test_serving_chunked.py:159: the chunked paged engine's
    tokens equal the cache-free greedy loop."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 100, (L,)).astype(np.int64)
               for L in (5, 23, 37)]
    eng = ServingEngine(model, max_slots=3, max_len=64, min_bucket=8,
                        page_size=8, prefill_chunk=8)
    for p, toks in zip(prompts, _drive(eng, prompts)):
        assert toks == _full_forward_greedy(model, p, 6)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_recover_after_decode_fault(model, layout, monkeypatch, tmp_path):
    """A decode step that fails mid-flight: ``recover()`` rebuilds the
    pool (the prompts by their admission's route, the delivered tokens by
    decode forwards) and the run ends with the fault-free run's tokens."""
    monkeypatch.setenv("PTPU_FLIGHT_DIR", str(tmp_path))
    prompts = _prompts(np.random.RandomState(4), [6, 19, 11, 33])
    news = [9, 7, 12, 6]
    lay = {"kv_layout": layout}
    want, _ = _serve(model, prompts, news, **lay)
    eng = ServingEngine(model, max_slots=3, max_len=64, min_bucket=8,
                        **lay, **({"page_size": 8} if layout == "paged"
                                  else {}))
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    faults.clear()
    try:
        faults.inject("serving.step.decode", times=1, after=3)
        with pytest.raises(faults.InjectedFault):
            eng.run()
        rep = eng.recover()
    finally:
        faults.clear()
    assert rep["recovered_slots"] and rep["replay_mismatches"] == 0
    eng.run()
    assert [r.output_ids for r in reqs] == want
    _quiesced(eng)


# -- weight-only int4 / int8 ---------------------------------------------

MIN_FEATURES, GROUP = 32, 16


@pytest.mark.parametrize("precision", ["int4", "int8"])
def test_weight_only_matches_reference(pair, precision):
    """The port's swap of the converted f32 model picks the reference's
    layers (every qkv, proj, fc1 and fc2; the tied head is a matmul
    against wte and stays), codes and scales; the reference's quantized
    GPT carried across gives its logits within 1e-4, and serves."""
    from paddle_tpu.quantization import weight_only_int4 as ref_int4
    from paddle_tpu.quantization import weight_only_int8 as ref_int8
    ref, port = pair
    if precision == "int4":
        rq = ref_int4(ref, group=GROUP, min_features=MIN_FEATURES,
                      inplace=False)
        pq = weight_only_int4(port, group=GROUP, min_features=MIN_FEATURES,
                              inplace=False)
    else:
        rq = ref_int8(ref, min_features=MIN_FEATURES, inplace=False)
        pq = weight_only_int8(port, min_features=MIN_FEATURES, inplace=False)
    rq.eval()
    state = _np_state(rq)
    layer = {"int4": Int4Linear, "int8": Int8Linear}[precision]
    swapped = sorted(n for n, m in pq.named_modules() if isinstance(m, layer))
    assert swapped == sorted(n[:-3] for n in state if n.endswith(".wq"))
    assert len(swapped) == 4 * KW["num_layers"]
    own = pq.state_dict()
    for name in swapped:
        np.testing.assert_array_equal(own[name + ".wq"].numpy(),
                                      state[name + ".wq"])
        np.testing.assert_array_equal(own[name + ".w_scale"].numpy(),
                                      state[name + ".w_scale"])
    conv = gpt_lm_from_jax_state(state, GPTConfig(**KW), device="cpu")
    assert isinstance(conv.gpt.blocks[0].fc2, layer)
    assert conv.gpt.blocks[0].fc2.bias is not None
    ids = np.random.RandomState(5).randint(0, 128, (2, 19))
    want = _ref_logits(rq, ids)
    with torch.no_grad():
        got = conv(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    prompts = _prompts(np.random.RandomState(6), [5, 12])
    toks, eng = _serve(conv, prompts, [4, 4])
    assert eng.adapter.kv_heads == H
    for p, t in zip(prompts, toks):
        assert t == _full_forward_greedy(conv, p, 4)


def test_adapter_reads_gpt_geometry(model):
    eng = ServingEngine(model, max_slots=2, max_len=32)
    ad = eng.adapter
    assert (ad.num_layers, ad.kv_heads, ad.head_dim, ad.max_positions) == \
        (KW["num_layers"], H, D, KW["max_seq_len"])
    assert ad.dtype == torch.float32 and ad.device.type == "cpu"
    with pytest.raises(ValueError, match="position range"):
        ServingEngine(model, max_len=128)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        GPTForCausalLM(GPTConfig(**KW), use_tp=True, device="cpu")
