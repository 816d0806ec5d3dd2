"""paddle_tpu_torch Llama against the reference (paddle_tpu, JAX on the
CPU): the converted weights compute the same logits, ``cache_attend``
gives the reference's outputs and buffers in every flavour, greedy
``generate()`` gives the reference's tokens, and the pieces below them
(RoPE, RMSNorm, SDPA) match.

Inputs come from numpy seeds; weights come from the reference model's
``state_dict()`` through ``llama_from_jax_state``. Everything is f32.
Tolerances: logits ``atol=rtol=1e-4`` (two layers of f32 matmuls in
another summation order); single ops ``1e-5``/``1e-6``; tokens exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.models._decode_cache import cache_attend as jax_cache_attend
from paddle_tpu.nn.functional.attention import _sdpa_xla
from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models._decode_cache import cache_attend
from paddle_tpu_torch.models.convert import llama_from_jax_state
from paddle_tpu_torch.nn.functional import rms_norm
from paddle_tpu_torch.nn.functional.attention import _sdpa

VARIANTS = {"mha": {}, "gqa": {"num_key_value_heads": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py: exact CPU numbers need
    # one intra-op thread in a process that also runs XLA
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(model):
    return {n: np.asarray(t._data) for n, t in model.state_dict().items()}


def _ref_logits(model, ids):
    """The reference forward as one jitted program (its eager,
    op-by-op mode computes the same but compiles every op)."""
    params, buffers = model.raw_state()

    def fwd(params, ids):
        with model.bind_state(params, buffers):
            return model(Tensor(ids))._data
    return np.asarray(jax.jit(fwd)(params, ids))


_jax_cache_attend = jax.jit(jax_cache_attend, static_argnums=(6,))


@pytest.fixture(scope="module")
def pairs():
    """variant -> (reference model, port model, port config) sharing
    weights, built on first use; the FFN (64 -> 128) and, for GQA, k/v
    (64 -> 32) are non-square, so a missed transpose cannot load."""
    built = {}

    def get(variant):
        if variant not in built:
            kw = dict(VARIANTS[variant], max_position_embeddings=128)
            paddle.seed(0)
            ref = jax_llama.LlamaForCausalLM(
                jax_llama.llama_tiny_config(**kw))
            ref.eval()
            cfg = port_llama.llama_tiny_config(**kw)
            built[variant] = (ref, llama_from_jax_state(
                _state(ref), cfg, device="cpu"), cfg)
        return built[variant]
    return get


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_reference(pairs, variant):
    ref, port, _ = pairs(variant)
    ids = np.random.RandomState(0).randint(0, 128, (2, 11))
    want = _ref_logits(ref, ids)
    with torch.no_grad():
        got = port(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_generate_greedy_matches_reference(pairs):
    """MHA only: GQA's cache math is held by the cache_attend cases and
    its model by the logits test; each reference generate() compiles
    a program of its own."""
    ref, port, _ = pairs("mha")
    ids = np.random.RandomState(1).randint(0, 128, (2, 7))
    want = ref.generate(paddle.to_tensor(ids), max_new_tokens=6).numpy()
    for use_cache in ("static", "dynamic", False):
        got = port.generate(torch.as_tensor(ids), max_new_tokens=6,
                            use_cache=use_cache).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(use_cache))


def test_converter_refuses_missed_transpose_and_wrong_names(pairs):
    ref, _, cfg = pairs("mha")
    state = _state(ref)
    name = "llama.layers.0.mlp.gate_proj.weight"            # [64, 128]
    bad = dict(state, **{name: state[name].T.copy()})
    with pytest.raises(RuntimeError):
        llama_from_jax_state(bad, cfg, device="cpu")
    extra = dict(state, **{"llama.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError):
        llama_from_jax_state(extra, cfg, device="cpu")
    missing = {k: v for k, v in state.items() if k != name}
    with pytest.raises(RuntimeError):
        llama_from_jax_state(missing, cfg, device="cpu")


# b, t, h, kv, p (int or per-row list), wlen
CACHE_CASES = {
    "scalar_prefill": (2, 6, 4, 4, 0, None),        # the flash branch
    "scalar_prefill_gqa": (2, 6, 4, 2, 0, None),    # masked einsum
    "scalar_block": (2, 4, 4, 2, 3, None),
    "scalar_wlen": (2, 3, 4, 2, 4, [3, 1]),         # chunked flavour
    "per_row": (3, 2, 4, 2, [0, 3, 7], None),
    "per_row_wlen": (3, 3, 4, 2, [0, 3, 14], [1, 3, 2]),
}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_attend_matches_reference(case):
    b, t, h, kv, p, wlen = CACHE_CASES[case]
    Tmax, D = 16, 8
    rng = np.random.RandomState(len(case))
    qr = rng.standard_normal((b, t, h, D)).astype(np.float32)
    kr, v = (rng.standard_normal((b, t, kv, D)).astype(np.float32)
             for _ in range(2))
    kc, vc = (rng.standard_normal((b, Tmax, kv, D)).astype(np.float32)
              for _ in range(2))
    per_row = isinstance(p, list)
    jp = jnp.asarray(p, jnp.int32)
    jw = None if wlen is None else jnp.asarray(wlen, jnp.int32)
    want = _jax_cache_attend(*(jnp.asarray(a) for a in (qr, kr, v, kc, vc)),
                            jp, per_row, wlen=jw)
    tp = torch.as_tensor(p) if per_row else p
    tw = None if wlen is None else torch.as_tensor(wlen)
    got = cache_attend(*(torch.from_numpy(a.copy())
                         for a in (qr, kr, v, kc, vc)), tp, per_row,
                       wlen=tw)
    for g, w, name in zip(got, want, ("out", "k_cache", "v_cache")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_rope_and_rms_norm_match_reference():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    cos, sin = jax_llama._rope_cache(8, 16, 10000.0)
    for c, s in ((cos[3:8], sin[3:8]),
                 (cos[[[0, 1, 2, 3, 4], [6, 7, 8, 9, 10]]],
                  sin[[[0, 1, 2, 3, 4], [6, 7, 8, 9, 10]]])):
        want = jax.jit(jax_llama._apply_rope)(
            jnp.asarray(x), jnp.asarray(c), jnp.asarray(s))
        got = port_llama._apply_rope(torch.from_numpy(x),
                                     torch.from_numpy(c), torch.from_numpy(s))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    want = paddle.nn.functional.rms_norm(paddle.to_tensor(h),
                                         paddle.to_tensor(w)).numpy()
    got = rms_norm(torch.from_numpy(h), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("sq,skv,masked", [(4, 4, False), (3, 7, False),
                                           (5, 5, True)])
def test_sdpa_plain_matches_reference(sq, skv, masked):
    rng = np.random.RandomState(sq * 10 + skv)
    q = rng.standard_normal((2, sq, 2, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 2, 8)).astype(np.float32)
            for _ in range(2))
    mask = (rng.random_sample((2, 1, sq, skv)) > 0.3) if masked else None
    if masked:
        mask[..., 0] = True            # no fully masked row
    ref = jax.jit(lambda q, k, v, m: _sdpa_xla(q, k, v, m, not masked,
                                               0.0, None))
    want = ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               None if mask is None else jnp.asarray(mask))
    got = _sdpa(torch.from_numpy(q), torch.from_numpy(k),
                torch.from_numpy(v),
                None if mask is None else torch.from_numpy(mask),
                not masked, 0.0, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_later_slice_flavours_raise():
    cfg = port_llama.llama_tiny_config()
    with pytest.raises(NotImplementedError):
        port_llama.LlamaForCausalLM(cfg, use_tp=True, device="cpu")
