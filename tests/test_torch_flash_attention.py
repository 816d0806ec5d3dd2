"""paddle_tpu_torch flash attention, forward and backward, against the
reference Pallas kernels (``paddle_tpu.ops.pallas_ops``, interpret mode
on the CPU).

Inputs are made with numpy from a seed and handed to both. On the CPU
the port's wrappers run their plain versions; the backward is compared
with ``jax.vjp`` of the reference's ``flash_attention_fwd`` and
``flash_attention_qkv_fused`` (their custom VJPs, i.e. the backward
kernels), both through the port's ``torch.autograd.Function`` and
through ``flash_attention_bwd_plain`` called directly. The CUDA tests at
the end (marked ``cuda``, skipped without a card) launch the Hopper
kernels and check that the kernels' callers send every square call on
the card to them, with gradients.

Tolerances: f32 on the CPU, forward ``atol=2e-5`` (the reference's own
flash test bar): both sides compute f32 scores and an f32 softmax, in a
different summation order; backward ``atol=1e-5`` on gradients of
magnitude ~1-10 (five f32 matmuls in another order). On the card the
kernels take bf16 and are held to their plain versions at
``atol=rtol=2e-2`` (bf16 rounding of out, of P and of dS) and
``atol=1e-3`` for ``lse``; the f32 kernels at ``1e-4`` (every product
of the forward and the backward 3xTF32, ~2^-21 of each product, in
another order); the 3xTF32 arithmetic of both is also held to that bar
on the CPU. Head_dims off the reference kernel's {64, 128, 256}
(32, 80, 96) are held to the reference kernel in interpret mode too,
and the wrapper's contract (every head_dim up to 256 whose row is a
whole number of 16 bytes, bf16/f16/f32) is checked on CPU tensors.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain, flash_attention_qkv_fused)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # In a process that has run XLA, torch's first multithreaded exp on
    # the CPU was seen to lose ~1e-4 relative accuracy on part of its
    # output; one intra-op thread keeps the CPU numbers exact (and the
    # test workers from oversubscribing the cores).
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _reference(q, k, v, causal):
    """Reference kernel's (out [B,S,H,D], lse [B,H,S]). Imported here:
    the card's machine runs the CUDA tests of this file without JAX."""
    import jax.numpy as jnp
    from paddle_tpu.ops import pallas_ops
    B, S, H, D = q.shape
    out, res = pallas_ops._flash_fwd_rule(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        1.0 / math.sqrt(D))
    lse = np.asarray(res[4]).reshape(B, H, S)
    return np.asarray(out), lse


@pytest.mark.parametrize("S,causal,block", [
    (40, True, None),      # ragged S: one block of 40 in the reference
    (40, False, None),
    (128, True, "64"),     # 2x2 blocks: the online-softmax carry
])
def test_plain_matches_pallas_interpret(S, causal, block, monkeypatch):
    if block is not None:
        monkeypatch.setenv("PTPU_FLASH_BLOCK", block)
    q, k, v = _qkv(1, S, 2, 64, seed=S + causal)
    ref_out, ref_lse = _reference(q, k, v, causal)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, return_lse=True)
    assert flash_attention_fwd.launches == before   # CPU: plain version
    np.testing.assert_allclose(out.numpy(), ref_out, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5)


def _ref_vjp(fn, args, g):
    """(out, input cotangents) of the reference function under
    ``jax.vjp``, jitted so each case compiles once."""
    import jax

    def run(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)
    out, grads = jax.jit(run)(args, g)
    return np.asarray(out), [np.asarray(a) for a in grads]


@pytest.mark.parametrize("S,causal", [
    (128, True),
    (40, False),           # ragged S: one block of 40 in the reference
])
def test_backward_matches_reference_vjp(S, causal):
    from paddle_tpu.ops import pallas_ops
    q, k, v = _qkv(1, S, 2, 128, seed=10 + S)
    g = np.random.RandomState(S).standard_normal(q.shape).astype(np.float32)
    ref_out, ref_grads = _ref_vjp(
        lambda q, k, v: pallas_ops.flash_attention_fwd(q, k, v,
                                                       causal=causal),
        (q, k, v), g)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = flash_attention_bwd.launches
    out = flash_attention_fwd(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(g))
    assert flash_attention_bwd.launches == before   # CPU: plain version
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=2e-5)
    o, lse = flash_attention_fwd_plain(*(t.detach() for t in (tq, tk, tv)),
                                       causal=causal)
    direct = flash_attention_bwd_plain(tq.detach(), tk.detach(),
                                       tv.detach(), o, lse,
                                       torch.from_numpy(g), causal=causal)
    for t, d, r in zip((tq, tk, tv), direct, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), r, atol=1e-5)
        np.testing.assert_allclose(d.numpy(), r, atol=1e-5)


def test_packed_backward_matches_reference_vjp():
    """``flash_attention_qkv_fused`` (non-causal here; the GPT trainer's
    test covers the causal packed path end to end): the output and the
    one ``[B, S, 3*H*D]`` gradient."""
    from paddle_tpu.ops import pallas_ops
    rng = np.random.RandomState(7)
    qkv = rng.standard_normal((1, 128, 3 * 2 * 128)).astype(np.float32)
    g = rng.standard_normal((1, 128, 2 * 128)).astype(np.float32)
    ref_out, (ref_grad,) = _ref_vjp(
        lambda x: pallas_ops.flash_attention_qkv_fused(x, 2, causal=False),
        (qkv,), g)
    t = torch.from_numpy(qkv).requires_grad_()
    out = flash_attention_qkv_fused(t, 2, causal=False)
    out.backward(torch.from_numpy(g))
    assert out.shape == (1, 128, 256) and t.grad.shape == t.shape
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=2e-5)
    np.testing.assert_allclose(t.grad.numpy(), ref_grad, atol=1e-5)


@pytest.mark.parametrize("D", [32, 80, 96])
def test_head_dims_beyond_64_128_256_match_reference_vjp(D):
    """head_dim off the reference kernel's {64, 128, 256} (which the
    card's kernels now take, tiled at the next width): the plain
    forward and backward against the reference kernel in interpret mode,
    f32, the scale 1/sqrt(D) of the true head_dim."""
    from paddle_tpu.ops import pallas_ops
    q, k, v = _qkv(1, 40, 2, D, seed=D)
    g = np.random.RandomState(D).standard_normal(q.shape).astype(np.float32)
    ref_out, ref_grads = _ref_vjp(
        lambda q, k, v: pallas_ops.flash_attention_fwd(q, k, v, causal=True),
        (q, k, v), g)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_fwd(tq, tk, tv, causal=True)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=2e-5)
    for t, r in zip((tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), r, atol=1e-5)


@pytest.mark.parametrize("D,dtype,ok", [
    (64, torch.bfloat16, True), (32, torch.bfloat16, True),
    (80, torch.bfloat16, True), (96, torch.bfloat16, True),
    (40, torch.float16, True), (256, torch.float16, True),
    (64, torch.float32, True), (128, torch.float32, True),
    (4, torch.float32, True), (36, torch.float32, True),
    (36, torch.bfloat16, False),     # 72 bytes: not whole 16-byte vectors
    (30, torch.float32, False),
    (264, torch.bfloat16, False),    # above 256
    (260, torch.float32, False),
    (64, torch.float64, False),
])
def test_kernel_contract_head_dims_and_dtypes(D, dtype, ok):
    """What the CUDA wrapper accepts (checked on CPU tensors: the
    check reads only dtype, shape, strides and alignment)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    t = torch.zeros(1, 8, 2, D, dtype=dtype)
    if dtype in fa._KERNEL_DTYPES:
        assert fa.kernel_takes_head_dim(D, dtype) == ok
    if ok:
        fa._check_cuda("flash", q=t, k=t, v=t)
    else:
        with pytest.raises(ValueError, match="head_dim|dtype"):
            fa._check_cuda("flash", q=t, k=t, v=t)


def test_kernel_contract_refuses_unaligned_rows():
    from paddle_tpu_torch.ops import flash_attention as fa
    buf = torch.zeros(1, 8, 2, 65)
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_cuda("flash", q=buf[..., 1:], k=buf[..., 1:],
                       v=buf[..., 1:])


@pytest.mark.parametrize("D,dtype,ok", [
    (36, torch.bfloat16, False), (64, torch.bfloat16, True),
    (128, torch.bfloat16, True), (256, torch.bfloat16, True),
    (264, torch.bfloat16, False),
    (36, torch.float32, True), (64, torch.float32, True),
    (128, torch.float32, True), (256, torch.float32, True),
    (264, torch.float32, False),
])
def test_kernel_takes_routes_by_head_dim_and_dtype(D, dtype, ok):
    """``kernel_takes``, the route the callers pick before any launch,
    reads only dtypes and head_dim, the terms of the reference's
    ``_pallas_eligible`` (so it answers on CPU tensors what the card
    would do): head_dim up to 256 with rows of a whole number of 16
    bytes, one dtype. Strides do not route: an unaligned view goes to
    the kernel, whose wrapper copies it to a dense tensor."""
    from paddle_tpu_torch.ops import flash_attention as fa
    t = torch.zeros(1, 8, 2, D, dtype=dtype)
    assert fa.kernel_takes(t, t, t) == ok
    assert fa.kernel_takes(t, t.to(torch.float16), t) is False
    buf = torch.zeros(1, 8, 2, D + 8, dtype=dtype)  # a wider row buffer
    assert fa.kernel_takes(buf[..., 8:], t, t) == ok          # aligned base
    assert fa.kernel_takes(buf[..., 1:D + 1], t, t) == ok     # 2-4 bytes in


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unaligned_views_are_copied_for_the_kernel(dtype):
    """``_aligned``, what the CUDA wrappers apply to q, k, v, out and
    dO: a view the TMA maps can read is passed as it is; a view with a
    misaligned base or strides becomes a dense copy with an aligned base
    and the same values (``contiguous`` alone would keep a dense view's
    misaligned base)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    buf = torch.randn(1, 8, 2, 72, generator=torch.Generator()
                      .manual_seed(0)).to(dtype)
    aligned = buf[..., 8:]
    assert fa._aligned(aligned) is aligned
    flat = torch.randn(2 * 8 * 2 * 64 + 1).to(dtype)
    shifted = flat[1:].view(2, 8, 2, 64)      # dense, base off by one
    for view in (buf[..., 1:65], shifted):
        assert not fa._kernel_strides_ok(view)
        copy = fa._aligned(view)
        assert fa._kernel_strides_ok(copy)
        assert torch.equal(copy, view)
        fa._check_cuda("flash", q=copy, k=copy, v=copy)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_plain_branch_matches_reference_at_head_dim_264(causal):
    """head_dim 264, which no kernel takes, computes through the port's
    ``_sdpa`` (the route ``scaled_dot_product_attention`` gives it on the
    card) as the reference's ``_sdpa_xla`` does; f32, atol 2e-5."""
    import jax.numpy as jnp
    from paddle_tpu.nn.functional.attention import _sdpa_xla
    from paddle_tpu_torch.nn.functional.attention import (
        _sdpa, scaled_dot_product_attention)
    q, k, v = _qkv(2, 24, 2, 264, seed=264 + causal)
    ref = np.asarray(_sdpa_xla(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), None, causal, 0.0, None))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(
        _sdpa(tq, tk, tv, None, causal, 0.0, None).numpy(), ref,
        atol=2e-5)
    before = flash_attention_fwd.launches
    out = scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    assert flash_attention_fwd.launches == before
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_cache_prefill_at_head_dim_264_takes_the_masked_einsum():
    """The cache's prefill at head_dim 264 takes the masked einsum (the
    reference's own path) and gives the reference's ``cache_attend``
    output and buffers; f32, atol 2e-5."""
    import jax.numpy as jnp
    from paddle_tpu.models import _decode_cache as ref_cache
    from paddle_tpu_torch.models import _decode_cache as cache
    rng = np.random.RandomState(11)
    B, t, H, D, Tmax = 1, 12, 2, 264, 16
    qr, kr, v = (rng.standard_normal((B, t, H, D)).astype(np.float32)
                 for _ in range(3))
    kc = np.zeros((B, Tmax, H, D), np.float32)
    ref_out, ref_kc, _ = ref_cache.cache_attend(
        jnp.asarray(qr), jnp.asarray(kr), jnp.asarray(v), jnp.asarray(kc),
        jnp.asarray(kc), 0, False)
    tkc, tvc = torch.zeros(B, Tmax, H, D), torch.zeros(B, Tmax, H, D)
    tq, tk, tv = (torch.from_numpy(a) for a in (qr, kr, v))
    assert not cache._flash_prefill(tq, tk, tkc, 0, None, False)
    out, kc2, _ = cache.cache_attend(tq, tk, tv, tkc, tvc, 0, False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5)
    np.testing.assert_allclose(kc2.numpy(), np.asarray(ref_kc), atol=0)
    small = torch.zeros(B, Tmax, H, 64)
    assert cache._flash_prefill(tq[..., :64], tk[..., :64], small, 0,
                                None, False)


def test_no_grad_calls_skip_the_function():
    """Serving (no_grad / inference_mode) takes the raw forward: no
    autograd node, nothing saved."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, 8, 2, 16, seed=5))
    with torch.inference_mode():
        assert flash_attention_fwd(q, k, v).grad_fn is None
    assert flash_attention_fwd(q, k, v).grad_fn is not None


def _tf32_pair(x):
    """The f32 kernel's split of f32 ``x`` into TF32 halves: hi rounded to
    TF32's 10 stored mantissa bits (to nearest, ties away), lo = x - hi,
    of which the tensor core reads the top 19 bits (the rest cut)."""
    hi = ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def _tf32_products(eq, a, b, terms: int):
    """``einsum(eq, a, b)`` as the f32 kernel's TF32 products form it:
    every product of TF32 values is exact in f32; 3 terms (lo hi + hi lo +
    hi hi, the kernel's 3xTF32) or 1 (hi hi, one TF32 product)."""
    (ah, al), (bh, bl) = _tf32_pair(a), _tf32_pair(b)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out


@pytest.mark.parametrize("D,causal", [(64, True), (128, False)])
def test_three_tf32_products_hold_the_f32_tolerance(D, causal):
    """The f32 forward's arithmetic (csrc/flash_attention_fwd.cu), both
    products as 3xTF32 with P unnormalised, holds the plain f32 version
    to the card tests' 1e-4 (out, atol=rtol) and 1e-5 (lse); one TF32
    product alone does not hold 1e-4."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 200, 2, D, D))
    scale = 1.0 / math.sqrt(D)
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    for terms in (3, 1):
        s = _tf32_products("bqhd,bkhd->bhqk", q, k, terms) * scale
        if causal:
            s = s.masked_fill(~torch.ones(200, 200, dtype=torch.bool).tril(),
                              -1e30)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        out = (_tf32_products("bhqk,bkhd->bhqd", p, v, terms) / l).transpose(
            1, 2)
        lse = (m + torch.log(l)).squeeze(-1)
        err = (out - ref).abs().max().item()
        if terms == 3:
            torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
        else:
            assert err > 1e-4


@pytest.mark.parametrize("D,causal", [(64, True), (128, False)])
def test_three_tf32_products_hold_the_f32_backward_tolerance(D, causal):
    """The f32 backward's arithmetic (csrc/flash_attention_bwd.cu): the
    dk/dv pass's S^T = K Q^T and dP^T = V dO^T, P^T and dS^T, dV = P^T dO
    and dK = dS^T Q; the dq pass's S = Q K^T and dP = dO V^T again, dS
    and dQ = dS K; every product 3xTF32 (P^T and dS^T split as the kernels
    split them), P from the saved lse. It holds the plain f32 backward to
    the card tests' 1e-4 (dq, dk, dv; atol=rtol); one TF32 product alone
    does not hold 1e-4."""
    S = 200
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, S, 2, D, 100 + D))
    do = torch.from_numpy(_qkv(1, S, 2, D, 200 + D)[0])
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    delta = (out * do).sum(-1).transpose(1, 2)           # [B, H, S]
    above = ~torch.ones(S, S, dtype=torch.bool).tril()  # key > query
    err = {}
    for terms in (3, 1):
        # the dk/dv pass: keys as rows, queries as columns
        st = _tf32_products("bkhd,bqhd->bhkq", k, q, terms)
        pt = torch.exp(st * scale - lse[:, :, None, :])
        if causal:
            pt = pt.masked_fill(above.T, 0.0)
        dpt = _tf32_products("bkhd,bqhd->bhkq", v, do, terms)
        dst = pt * (dpt - delta[:, :, None, :]) * scale
        dv = _tf32_products("bhkq,bqhd->bkhd", pt, do, terms)
        dk = _tf32_products("bhkq,bqhd->bkhd", dst, q, terms)
        # the dq pass: queries as rows
        s = _tf32_products("bqhd,bkhd->bhqk", q, k, terms)
        p = torch.exp(s * scale - lse[..., None])
        if causal:
            p = p.masked_fill(above, 0.0)
        dp = _tf32_products("bqhd,bkhd->bhqk", do, v, terms)
        ds = p * (dp - delta[..., None]) * scale
        dq = _tf32_products("bhqk,bkhd->bqhd", ds, k, terms)
        err[terms] = max((a - b).abs().max().item()
                         for a, b in zip((dq, dk, dv), ref))
        if terms == 3:
            for a, b in zip((dq, dk, dv), ref):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    assert err[1] > 1e-4 > err[3]


def test_plain_takes_strided_inputs_and_mixed_dtypes():
    """The plain version reads any strides (the cache path hands it
    buffer views) and computes f32 scores from a bf16 key."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 24, 2, 16, seed=3))
    buf = torch.zeros(2, 64, 2, 16)
    buf[:, :24] = k
    out = flash_attention_fwd(q, buf[:, :24], v, causal=True)
    np.testing.assert_allclose(
        out.numpy(), flash_attention_fwd(q, k, v, causal=True).numpy(),
        atol=1e-6)
    kb = k.bfloat16()
    out16, _ = flash_attention_fwd_plain(q, kb, v, causal=True)
    out32, _ = flash_attention_fwd_plain(q, kb.float(), v, causal=True)
    np.testing.assert_allclose(out16.numpy(), out32.numpy(), atol=0)


def test_wrapper_rejects_bad_shapes_and_mixed_devices():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 2, 16, seed=4))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k[:, :4], v)
    with pytest.raises(ValueError):
        flash_attention_fwd(q[0], k[0], v[0])
    with pytest.raises(ValueError):
        flash_attention_fwd(q, k.to("meta"), v)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,causal", [(24, 128, True), (300, 128, True),
                                        (200, 64, False), (300, 256, True)])
def test_cuda_kernel_matches_plain_and_counts(cuda, S, D, causal):
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(1, S, 4, D, device=cuda, generator=g)
               .bfloat16() for _ in range(3))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 16, 2, 264, device=cuda).bfloat16()
    with pytest.raises(ValueError):          # head_dim above 256
        flash_attention_fwd(q, q, q)
    h = torch.randn(1, 16, 2, 36, device=cuda).bfloat16()
    with pytest.raises(ValueError):          # 72-byte rows
        flash_attention_fwd(h, h, h)
    d = torch.randn(1, 16, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):          # f64: no silent plain path
        flash_attention_fwd(d, d, d)


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype,causal", [
    (32, torch.bfloat16, True), (80, torch.bfloat16, True),
    (96, torch.bfloat16, False), (40, torch.float16, True),
    (200, torch.bfloat16, True), (64, torch.float32, True),
    (128, torch.float32, False), (36, torch.float32, True)])
def test_cuda_every_head_dim_and_f32_match_plain(cuda, D, dtype, causal):
    """Forward and backward at head_dims off {64, 128, 256} and in f32
    against the plain versions (16-bit: the bf16 tolerances; f32: 1e-4,
    3xTF32 products in another order), one launch each, the same bits
    twice."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v, do = (torch.randn(2, 150, 3, D, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do, causal)
    again = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 2)
    ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3 if tol > 1e-4
                               else 1e-5, rtol=0)
    for a, b, p in zip(first, again, plain):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), p.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [("bfloat16", 128), ("bfloat16", 256),
                                     ("float32", 128)])
def test_cuda_model_attention_launches_or_raises(cuda, dtype, D):
    """SDPA (the uncached forward) and the cache's prefill branch
    (generate()) route every square causal call on the card to the
    wrapper: a bf16 or f32 model launches once per layer in each (f32
    on the f32 kernel), and nothing runs the plain version there."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    cfg = llama_tiny_config(hidden_size=2 * D, num_attention_heads=2,
                            max_position_embeddings=128)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = LlamaForCausalLM(cfg, device=cuda, dtype=dtype, generator=g)
    ids = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda,
                        generator=g)
    L = cfg.num_hidden_layers
    before = flash_attention_fwd.launches
    with torch.no_grad():
        logits = model(ids)
    assert flash_attention_fwd.launches == before + L
    out = model.generate(ids, max_new_tokens=2)     # prefill + 1 decode
    assert flash_attention_fwd.launches == before + 2 * L
    assert out.shape == (1, 42) and torch.isfinite(logits.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,D,causal", [
    (1, 128, 2, 128, True), (1, 300, 4, 128, True), (2, 200, 2, 64, False),
    (1, 300, 2, 256, True)])
def test_cuda_backward_matches_plain_and_repeats(cuda, B, S, H, D, causal):
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v, do = (torch.randn(B, S, H, D, device=cuda, generator=g)
                   .bfloat16() for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    before = flash_attention_bwd.launches
    first = flash_attention_bwd(q, k, v, out, lse, do, causal)
    again = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for a, b, p in zip(first, again, plain):
        assert torch.equal(a, b)            # no atomics: same bits
        torch.testing.assert_close(a.float(), p.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
def test_cuda_packed_backward_writes_one_gradient(cuda):
    """The packed path launches once each way and gives the bits of the
    unpacked path on the same views."""
    g = torch.Generator(device=cuda).manual_seed(1)
    B, S, H, D = 2, 256, 4, 128
    qkv = torch.randn(B, S, 3 * H * D, device=cuda, generator=g).bfloat16()
    do = torch.randn(B, S, H * D, device=cuda, generator=g).bfloat16()
    qkv.requires_grad_()
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    out = flash_attention_qkv_fused(qkv, H, causal=True)
    out.backward(do)
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    views = [t.detach().clone().requires_grad_()
             for t in qkv.detach().view(B, S, 3, H, D).unbind(2)]
    out2 = flash_attention_fwd(*views, causal=True)
    out2.backward(do.view(B, S, H, D))
    assert torch.equal(out.view(B, S, H, D), out2)
    for i, t in enumerate(views):
        assert torch.equal(qkv.grad.view(B, S, 3, H, D)[:, :, i], t.grad)


@pytest.mark.cuda
def test_cuda_llama_backward_has_attention_gradients(cuda):
    """The fault slice 1 left: on the card the kernel's output had no
    grad_fn, so a Llama backward dropped every q/k/v gradient. Now
    ``forward().sum().backward()`` through the kernels gives q/k/v
    projection gradients equal to the plain route's (a mask sends SDPA
    to its plain masked einsum, which autograd differentiates) within
    5e-2 of their norm: bf16 q and k at the kernel against f32 q and k
    (RoPE's f32 tables) in the plain route, through two layers."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    cfg = llama_tiny_config(hidden_size=256, num_attention_heads=2,
                            max_position_embeddings=128)
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = LlamaForCausalLM(cfg, device=cuda, dtype="bfloat16",
                             generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda,
                        generator=gen)
    names = [f"llama.layers.{i}.self_attn.{p}_proj.weight"
             for i in range(cfg.num_hidden_layers) for p in "qkv"]
    params = dict(model.named_parameters())

    def grads(**kw):
        model.zero_grad(set_to_none=True)
        model(ids, **kw).float().sum().backward()
        return [params[n].grad.float().clone() for n in names]
    before = flash_attention_bwd.launches
    kernel = grads()
    assert flash_attention_bwd.launches == before + cfg.num_hidden_layers
    plain = grads(attn_mask=torch.ones(2, 1, 96, 96, dtype=torch.bool,
                                       device=cuda))
    for n, a, b in zip(names, kernel, plain):
        assert b.norm() > 0, n
        assert (a - b).norm() <= 5e-2 * b.norm(), n


@pytest.mark.cuda
@pytest.mark.parametrize("D,dtype", [(128, torch.bfloat16),
                                     (64, torch.float16),
                                     (36, torch.float32),
                                     (128, torch.float32),
                                     (256, torch.float32)])
def test_cuda_padded_prefix_is_bitwise(cuda, D, dtype):
    """A causal row depends only on its own prefix: rows 0..299 of an
    S=512 call whose positions past 300 are padding equal the S=300
    call bit for bit, out and lse (the key tile follows the tile width,
    never S; the serving engine's bucket padding relies on it)."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v = (torch.randn(1, 512, 4, D, device=cuda, generator=g)
               .to(dtype) for _ in range(3))
    out, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    cut = [t[:, :300].contiguous() for t in (q, k, v)]
    out3, lse3 = flash_attention_fwd(*cut, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :300], out3)
    assert torch.equal(lse[..., :300], lse3)


@pytest.mark.cuda
def test_cuda_trainer_packed_shape_matches_plain_and_repeats(cuda):
    """The GPT-1.3B trainer's call (B=6, S=1024, H=16, D=128, causal, q,
    k, v and dq, dk, dv views of packed buffers): forward and backward
    against the plain versions (atol=rtol=2e-2, lse 1e-3), the backward
    the same bits twice."""
    B, S, H, D = 6, 1024, 16, 128
    g = torch.Generator(device=cuda).manual_seed(6)
    qkv = torch.randn(B, S, 3 * H * D, device=cuda, generator=g).bfloat16()
    q, k, v = qkv.view(B, S, 3, H, D).unbind(2)
    do = torch.randn(B, S, H, D, device=cuda, generator=g).bfloat16()
    out, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    del ref_out, ref_lse
    dqkv = torch.empty_like(qkv)
    views = dqkv.view(B, S, 3, H, D).unbind(2)
    flash_attention_bwd(q, k, v, out, lse, do, True, None, *views)
    first = dqkv.clone()
    flash_attention_bwd(q, k, v, out, lse, do, True, None, *views)
    torch.cuda.synchronize()
    assert torch.equal(first, dqkv)
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
    for a, p in zip(views, plain):
        torch.testing.assert_close(a.float(), p.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 160, 192])
def test_cuda_wgmma_tile_widths_match_plain(cuda, D, dtype, causal):
    """The wgmma kernels at the tile widths 32, 64, 96, 128 and 192 (160
    runs at 192 with zero-filled columns; 192 has its own 32-column
    panels and, in the backward, output columns split across three
    panels a warpgroup), both 16-bit dtypes, a ragged S=300: forward and
    backward against the plain versions (atol=rtol=2e-2, lse 1e-3), one
    launch each, the backward the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(D + causal)
    q, k, v, do = (torch.randn(2, 300, 3, D, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do, causal)
    again = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 2)
    ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for a, b, p in zip(first, again, plain):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), p.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
def test_cuda_head_dim_264_llama_takes_the_plain_route(cuda):
    """A tiny Llama at head_dim 264, which no kernel takes: its forward
    (SDPA) and generate() (the cache's prefill and decode) run on the
    card with no flash launch, and give the logits and tokens of the
    same weights on the CPU (f32; the card's f32 matmuls run without
    TF32, atol 1e-3). Calling the flash op on such tensors still
    raises."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    cfg = llama_tiny_config(hidden_size=2 * 264, num_attention_heads=2,
                            max_position_embeddings=64)
    model = LlamaForCausalLM(cfg, device=cuda, dtype="float32",
                             generator=torch.Generator(cuda).manual_seed(0))
    host = LlamaForCausalLM(cfg, device="cpu", dtype="float32")
    host.load_state_dict({n: t.cpu() for n, t in model.state_dict().items()})
    ids = torch.randint(0, cfg.vocab_size, (1, 24),
                        generator=torch.Generator().manual_seed(1))
    before = flash_attention_fwd.launches
    with torch.no_grad():
        logits = model(ids.to(cuda))
        host_logits = host(ids)
    out = model.generate(ids.to(cuda), max_new_tokens=4)
    assert flash_attention_fwd.launches == before
    torch.testing.assert_close(logits.cpu(), host_logits, atol=1e-3,
                               rtol=1e-3)
    assert torch.equal(out.cpu(), host.generate(ids, max_new_tokens=4))
    q = torch.randn(1, 16, 2, 264, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q)


@pytest.mark.cuda
def test_cuda_unaligned_views_launch_the_kernel(cuda):
    """q, k, v whose base and strides the TMA maps cannot read (views one
    element into rows of D+1) still take the kernel: through the port's
    SDPA, and through ``flash_attention_fwd`` with autograd, whose
    backward gets the same views. The wrappers copy them; one forward
    launch each and one backward launch, against the plain versions
    (atol=rtol=2e-2, lse 1e-3)."""
    from paddle_tpu_torch.nn.functional.attention import (
        scaled_dot_product_attention)
    B, S, H, D = 2, 150, 4, 64
    g = torch.Generator(device=cuda).manual_seed(65)
    buf = torch.randn(3, B, S, H, D + 1, device=cuda,
                      generator=g).bfloat16()
    do = torch.randn(B, S, H, D, device=cuda, generator=g).bfloat16()
    q, k, v = (t[..., 1:] for t in buf)
    ref_out, ref_lse = flash_attention_fwd_plain(q, k, v, causal=True)
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    out = scaled_dot_product_attention(q, k, v, is_causal=True)
    leaf = buf.clone().requires_grad_()
    lq, lk, lv = (t[..., 1:] for t in leaf)
    out2, lse = flash_attention_fwd(lq, lk, lv, causal=True,
                                    return_lse=True)
    out2.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) \
        == (before[0] + 2, before[1] + 1)
    for o in (out, out2):
        torch.testing.assert_close(o.float(), ref_out.float(), atol=2e-2,
                                   rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    plain = flash_attention_bwd_plain(q, k, v, out2.detach(), lse, do,
                                      causal=True)
    assert not leaf.grad[..., 0].any()
    for a, p in zip(leaf.grad[..., 1:], plain):
        torch.testing.assert_close(a.float(), p.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 37, 300, 512])
@pytest.mark.parametrize("D", [4, 36, 64, 128, 256])
def test_cuda_f32_forward_on_packed_views_matches_plain(cuda, D, S, causal):
    """The f32 forward (3xTF32 products on wgmma) against the plain
    version (f32 einsums, TF32 off) at each tile width's edges (4 and 36
    run at widths 32 and 64 with zero columns), a one-row, a ragged and
    whole tiles' S, causal and not, with q, k, v strided views of one
    packed [B, S, 3 H D] projection: one launch and no copy, out within
    1e-4 (atol=rtol), lse within 1e-5."""
    assert not torch.backends.cuda.matmul.allow_tf32
    B, H = 2, 3
    g = torch.Generator(device=cuda).manual_seed(1000 * D + S)
    qkv = torch.randn(B, S, 3 * H * D, device=cuda, generator=g)
    q, k, v = qkv.view(B, S, 3, H, D).unbind(2)
    from paddle_tpu_torch.ops import flash_attention as fa
    assert all(fa._aligned(t) is t for t in (q, k, v))
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 37, 300, 512])
@pytest.mark.parametrize("D", [4, 36, 64, 128, 256])
def test_cuda_f32_backward_on_packed_views_matches_plain(cuda, D, S, causal):
    """The f32 backward (every product 3xTF32 on wgmma) against the plain
    version (f32 einsums, TF32 off) at each tile width's edges (4 and 36
    run at widths 32 and 64 with zero columns), a one-row, a ragged and
    whole tiles' S, causal and not, with q, k, v views of one packed
    [B, S, 3 H D] projection and dq, dk, dv views of one packed gradient:
    one f32 launch a call and no copy, within 1e-4 (atol=rtol), the same
    bits twice."""
    assert not torch.backends.cuda.matmul.allow_tf32
    B, H = 2, 3
    g = torch.Generator(device=cuda).manual_seed(1000 * D + S + causal)
    qkv = torch.randn(B, S, 3 * H * D, device=cuda, generator=g)
    q, k, v = qkv.view(B, S, 3, H, D).unbind(2)
    do = torch.randn(B, S, H, D, device=cuda, generator=g)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    dqkv = torch.empty_like(qkv)
    views = dqkv.view(B, S, 3, H, D).unbind(2)
    before = (flash_attention_bwd.launches, flash_attention_bwd.f32_launches)
    flash_attention_bwd(q, k, v, out, lse, do, causal, None, *views)
    first = dqkv.clone()
    flash_attention_bwd(q, k, v, out, lse, do, causal, None, *views)
    torch.cuda.synchronize()
    assert (flash_attention_bwd.launches, flash_attention_bwd.f32_launches) \
        == (before[0] + 2, before[1] + 2)
    assert torch.equal(first, dqkv)
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for a, p in zip(views, plain):
        torch.testing.assert_close(a, p, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_f32_backward_at_width_192_matches_plain(cuda, causal):
    """The f32 backward at tile width 192 (160 and 192 run there: 16-row
    streamed tiles, the transposed tiles in 64-byte panels) on separate
    [B, S, H, D] tensors, a ragged S: within 1e-4 of the plain version,
    the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(192 + causal)
    q, k, v, do = (torch.randn(2, 300, 3, 192, device=cuda, generator=g)
                   for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do, causal)
    again = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for a, b, p in zip(first, again, plain):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, p, atol=1e-4, rtol=1e-4)
