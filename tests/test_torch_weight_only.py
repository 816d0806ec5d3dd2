"""paddle_tpu_torch weight-only int4 and int8 Llama against the reference
(``paddle_tpu.quantization``, JAX on the CPU).

One tiny reference Llama (2 layers, hidden 64, FFN 96, f32, seed 0) per
module. Its ``weight_only_int4(group=32)`` and ``weight_only_int8``
copies (``min_features=32`` on both sides, so every linear qualifies;
``down_proj``'s in 96 takes int4's group fallback, gcd(48, 32) = 16)
carry across through ``llama_from_jax_state``, and the reference runs
one jitted program per precision: its forward over the three requests'
rows, zero-padded to one fixed length, which gives its greedy tokens
(a step a call) and then its logits over every prompt and its tokens
(the reference's ``generate()`` and ``ServingEngine`` give these
greedy tokens, as its own tests hold).

- The swaps: the port's quantizers pick the same layers, the same groups
  and the same codes and scales bit for bit as the reference's, from the
  port's transposed weights.
- Prefill logits, and the logits of every static-cache decode step along
  the reference's tokens, within ``atol=rtol=1e-4`` of the reference's
  (two layers of f32 products in another order; the int8 codes agree).
  ``generate()``'s tokens and the engine's output ids exactly.
- The repair: a quantized GQA model builds its caches in ``generate()``
  and in ``ServingEngine`` (``k_proj.out_features``).
"""
import functools

import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu_torch.models import llama as port_llama
from paddle_tpu_torch.models.convert import llama_from_jax_state
from paddle_tpu_torch.quantization import (Int4Linear, Int8Linear,
                                           weight_only_int4, weight_only_int8)
from paddle_tpu_torch.serving import ServingEngine

KW = dict(intermediate_size=96, max_position_embeddings=64)
MIN_FEATURES = 32
GROUP = 32
PORT_SWAP = {
    "int4": lambda m: weight_only_int4(m, group=GROUP,
                                       min_features=MIN_FEATURES,
                                       inplace=False),
    "int8": lambda m: weight_only_int8(m, min_features=MIN_FEATURES,
                                       inplace=False)}
# (prompt length, max_new_tokens); request 0's prompt is the one the
# logits tests run
REQUESTS = [(7, 4), (5, 3), (3, 5)]
LAYER = {"int4": Int4Linear, "int8": Int8Linear}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(model):
    return {n: np.asarray(t._data) for n, t in model.state_dict().items()}


def _ref_greedy(model, prompts):
    """The reference's greedy tokens for REQUESTS and its logits over
    each prompt followed by them, from one jitted forward over a fixed
    ``[len(prompts), T]`` batch: each row zero-padded on the right, which
    causal attention keeps out of the positions before it."""
    import jax
    from paddle_tpu.framework.tensor import Tensor
    params, buffers = model.raw_state()

    @jax.jit
    def fwd(params, ids):
        with model.bind_state(params, buffers):
            return model(Tensor(ids))._data
    lens = [len(p) for p in prompts]
    seq = np.zeros((len(prompts), max(n + new for n, new in REQUESTS)),
                   np.int64)
    for i, p in enumerate(prompts):
        seq[i, :lens[i]] = p
    for step in range(max(new for _, new in REQUESTS)):
        logits = np.asarray(fwd(params, seq))
        for i, (n, new) in enumerate(REQUESTS):
            if step < new:
                seq[i, n + step] = logits[i, n + step - 1].argmax()
    logits = np.asarray(fwd(params, seq))
    return ([list(seq[i, n:n + new]) for i, (n, new) in enumerate(REQUESTS)],
            logits)


def _engine_ids(model, prompts):
    eng = ServingEngine(model, max_slots=2, max_len=32, min_bucket=16,
                     kv_layout="contiguous")
    reqs = [eng.submit(p, max_new_tokens=n)
            for p, (_, n) in zip(prompts, REQUESTS)]
    eng.run()
    return [list(r.output_ids) for r in reqs]


@pytest.fixture(scope="module")
def reference():
    """The reference f32 model, and per precision (built on first use)
    its quantized copy, the port model converted from that copy, the
    prompts, the reference's greedy tokens and its logits over request
    0's prompt followed by its tokens."""
    import paddle_tpu as paddle
    from paddle_tpu.models import llama as jax_llama
    from paddle_tpu.quantization import weight_only_int4 as ref_int4
    from paddle_tpu.quantization import weight_only_int8 as ref_int8
    paddle.seed(0)
    base = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny_config(**KW))
    base.eval()
    swaps = {"int4": lambda m: ref_int4(m, group=GROUP,
                                        min_features=MIN_FEATURES,
                                        inplace=False),
             "int8": lambda m: ref_int8(m, min_features=MIN_FEATURES,
                                        inplace=False)}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int64)
               for n, _ in REQUESTS]
    built = {}

    def get(precision):
        if precision not in built:
            q = swaps[precision](base)
            port = llama_from_jax_state(_np_state(q),
                                        port_llama.llama_tiny_config(**KW),
                                        device="cpu")
            ids, logits = _ref_greedy(q, prompts)
            seq = np.concatenate([prompts[0], ids[0]])[None]
            built[precision] = dict(ref=q, port=port, ids=ids, seq=seq,
                                    logits=logits[:1, :seq.shape[1]])
        return built[precision]
    get.base, get.prompts = base, prompts
    return get


def _sub(ref_model, name):
    return functools.reduce(lambda m, n: m._sub_layers[n], name.split("."),
                            ref_model)


@pytest.mark.parametrize("precision", ["int4", "int8"])
def test_swaps_match_reference(reference, precision):
    base = llama_from_jax_state(_np_state(reference.base),
                                port_llama.llama_tiny_config(**KW),
                                device="cpu")
    ref = reference(precision)["ref"]
    want = {n: a for n, a in _np_state(ref).items()
            if n.endswith((".wq", ".w_scale"))}
    swapped = PORT_SWAP[precision](base)
    got = {n: t.numpy() for n, t in swapped.state_dict().items()
           if n.endswith((".wq", ".w_scale"))}
    assert sorted(got) == sorted(want) and len(got) == 2 * (2 * 7 + 1)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    for n in {k.rpartition(".")[0] for k in got}:
        layer = swapped.get_submodule(n)
        assert isinstance(layer, LAYER[precision])
        if precision == "int4":
            assert layer.group == _sub(ref, n).group, n
    if precision == "int4":                              # gcd(48, 32)
        assert swapped.get_submodule("llama.layers.0.mlp.down_proj") \
            .group == 16
    assert isinstance(base.lm_head, nn.Linear)          # inplace=False


@pytest.mark.parametrize("precision", ["int4", "int8"])
def test_converted_prefill_logits_match_reference(reference, precision):
    r = reference(precision)
    assert isinstance(r["port"].lm_head, LAYER[precision])
    with torch.no_grad():
        got = r["port"](torch.as_tensor(r["seq"])).numpy()
    np.testing.assert_allclose(got, r["logits"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("precision", ["int4", "int8"])
def test_decode_steps_along_reference_tokens(reference, precision):
    """The static-cache path of ``generate()``, fed the reference's
    tokens: every step's logits are the reference's at that position;
    and ``generate()`` itself gives the reference's tokens."""
    r = reference(precision)
    port, seq, T0 = r["port"], r["seq"], len(reference.prompts[0])
    ids = torch.as_tensor(seq)
    new = seq.shape[1] - T0
    caches, pos, nxt, steps = port._static_caches(ids[:, :T0], new), 0, \
        ids[:, :T0], []
    with torch.inference_mode():
        for i in range(new):
            caches = [(c[0], c[1], pos) for c in caches]
            pos += nxt.shape[1]
            h, caches = port.llama(nxt, caches=caches)
            steps.append(port._head(h[:, -1:])[0, -1].numpy())
            nxt = ids[:, T0 + i:T0 + i + 1]
    np.testing.assert_allclose(np.stack(steps), r["logits"][0, T0 - 1:-1],
                               atol=1e-4, rtol=1e-4)
    out = port.generate(ids[:, :T0], max_new_tokens=new)
    np.testing.assert_array_equal(out.numpy(), seq)


@pytest.mark.parametrize("precision", ["int4", "int8"])
def test_engine_ids_match_reference(reference, precision):
    r = reference(precision)
    assert _engine_ids(r["port"], reference.prompts) \
        == r["ids"]


@pytest.mark.parametrize("precision", ["int4", "int8"])
def test_quantized_gqa_model_builds_caches(precision):
    """``generate()`` and ``ServingEngine`` read the KV width from
    ``k_proj.out_features``: a quantized layer has no ``weight``."""
    cfg = port_llama.llama_tiny_config(num_key_value_heads=2, **KW)
    model = PORT_SWAP[precision](port_llama.LlamaForCausalLM(
        cfg, device="cpu"))
    k_proj = model.llama.layers[0].self_attn.k_proj
    assert isinstance(k_proj, LAYER[precision]) and k_proj.out_features == 32
    ids = torch.as_tensor(np.random.RandomState(3).randint(0, 128, (2, 5)))
    caches = model._static_caches(ids, 4)
    assert caches[0][0].shape == (2, 64, 2, cfg.head_dim)
    assert model.generate(ids, max_new_tokens=4).shape == (2, 9)
    eng = ServingEngine(model, max_slots=2, max_len=32, min_bucket=16)
    assert eng.adapter.kv_heads == 2
    req = eng.submit(ids[0], max_new_tokens=3)
    eng.run()
    assert len(req.output_ids) == 3


def test_int8_static_scale_and_padding_match_reference():
    """``Int8Linear`` with a calibrated activation scale against the
    reference's, at 5 rows (the port pads ``torch._int_mm``'s A to 17)
    and 40 rows (the dynamic scale is held by the model tests). Both
    take the same codes; f32 epilogues agree to 1e-6 of the output."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn
    from paddle_tpu.quantization import Int8Linear as RefInt8Linear
    paddle.seed(1)
    ref_lin = jnn.Linear(64, 48)
    port_lin = nn.Linear(64, 48)
    with torch.no_grad():
        port_lin.weight.copy_(torch.from_numpy(ref_lin.weight.numpy().T.copy()))
        port_lin.bias.copy_(torch.from_numpy(ref_lin.bias.numpy().copy()))
    rng = np.random.RandomState(4)
    ref_q = RefInt8Linear(ref_lin, np.float32(3.5))
    port_q = Int8Linear(port_lin, np.float32(3.5))
    assert port_q.act_scale == ref_q.act_scale
    np.testing.assert_array_equal(port_q.wq.numpy(),
                                  np.asarray(ref_q.wq._data))
    assert port_q.wq.t().is_contiguous()                # column-major B
    for M in (5, 40):
        x = rng.standard_normal((M, 64)).astype(np.float32)
        want = ref_q(paddle.to_tensor(x)).numpy()
        got = port_q(torch.from_numpy(x).requires_grad_())
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_int8_refuses_conv_the_reference_would_swap():
    model = nn.Sequential(nn.Conv2d(3, 8, 3), nn.Linear(256, 256),
                          nn.Linear(16, 16))
    swapped = weight_only_int8(model, inplace=False)
    assert [type(m) for m in swapped] == [nn.Conv2d, Int8Linear, nn.Linear]
    assert isinstance(model[1], nn.Linear)
    big = nn.Sequential(nn.Linear(256, 256), nn.Conv2d(64, 8, 1))
    with pytest.raises(NotImplementedError, match="vision slice"):
        weight_only_int8(big)
    assert isinstance(big[0], nn.Linear)                # nothing swapped


def test_converter_refuses_bad_codes(reference):
    state = _np_state(reference("int4")["ref"])
    cfg = port_llama.llama_tiny_config(**KW)
    name = "llama.layers.0.mlp.gate_proj"
    for bad, err in (
            ({name + ".wq": state[name + ".wq"].astype(np.int16)},
             ValueError),
            ({name + ".wq": state[name + ".wq"][:, :64]}, ValueError),
            ({name + ".w_scale": state[name + ".w_scale"][:1, :80]},
             ValueError),
            ({"llama.layers.0.mlp.wq": state[name + ".wq"]}, KeyError),
            ({"llama.layers.9.mlp.gate_proj.wq": state[name + ".wq"]},
             AttributeError)):
        with pytest.raises(err):
            llama_from_jax_state(dict(state, **bad), cfg, device="cpu")
