"""paddle_tpu_torch's LayerNorm-fused int8 quantizes (kernel rows 10 and
11), the LN-fused all-int8 linear, the lower int8 tiers and the int8
cross-entropy against the reference (``paddle_tpu.ops.quant_matmul``,
``paddle_tpu.ops.fused_ce``, JAX on the CPU).

Inputs are made with numpy from a seed and handed to both packages.

- Row 10: the plain version against ``_rowq_ln_call(x, g, b, True)``
  (Pallas in interpret mode) in f32 and bf16 at ``[64, 256]``: codes
  within +-1 on at most 0.1%, scale, mean and rstd within 1e-5
  relative (the reference's own bars, ``tests/test_quant_pallas.py:
  245-264``; the two sum a row in other orders). A constant row
  (variance 0) and a column with g = b = 0 come out as LayerNorm says.
- Row 11 has no bitwise oracle (``pltpu.prng_seed`` has no CPU
  lowering). Its plain version is held to ``_sr_colq_xla``'s laws
  (every code the floor or the ceiling of h / scale, the mean over 256
  seeds within 4 standard errors, scale 1/127 and codes 0 on an
  all-zero column), and against the unfused quantize of the port with
  the same seed: bitwise given the same statistics, and with the
  statistics of the port's LayerNorm, scales within 1e-5 relative and
  codes within 1 on under 1%.
- ``int8_ln_linear_all8`` (both ``fuse_bwd_colq``), ``int8_linear`` and
  ``int8_linear_dgrad8`` against the reference's ``custom_vjp``s at
  small f32 shapes: the RTN forward and dgrad (and the exact products)
  to 1e-5 of the norm, the LN-fused ones to 2e-4 (row 10 sums in
  another order than XLA, moving a few codes by one); the SR wgrad
  within 1.5 times the reference's own seed-to-seed distance.
- ``fused_softmax_cross_entropy(int8=True)``, vocab-major (the tied
  head) and head-major, 4 chunks: loss to 1e-5, dx and dhead to 1e-5 of
  their norm.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import quant_matmul as qm
from paddle_tpu_torch.ops.fused_ce import fused_softmax_cross_entropy
from paddle_tpu_torch.ops.layer_norm import ln_fwd


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ln_inputs(shape, seed):
    """x with a per-row offset and spread, g near 1, b near 0."""
    rng = np.random.RandomState(seed)
    M, K = shape
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 3, (M, 1))
         + rng.uniform(-1, 1, (M, 1))).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(K)).astype(np.float32)
    return x, g, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel(got, want):
    return np.linalg.norm(np.asarray(got) - np.asarray(want)) / \
        np.linalg.norm(np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row10_matches_the_pallas_kernel(dtype):
    import jax.numpy as jnp
    from paddle_tpu.ops.quant_matmul import _rowq_ln_call
    x, g, b = _ln_inputs((64, 256), 0)
    ref = _rowq_ln_call(jnp.asarray(x).astype(dtype), jnp.asarray(g),
                        jnp.asarray(b), True)
    tx, tg, tb = _t(x, g, b)
    got = qm.ln_quantize_rowwise(tx.to(getattr(torch, dtype)), tg, tb)
    dq = np.abs(got[0].numpy().astype(np.int32) - np.asarray(ref[0], np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() <= 1e-3
    for a, r in zip(got[1:], ref[1:]):
        assert a.shape == (64, 1) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5)


def test_row10_constant_row_and_zero_gain_column():
    """Variance 0: rstd = 1/sqrt(eps) and h = b; a column with g = b = 0
    gives code 0 in every row."""
    x, g, b = _ln_inputs((16, 128), 1)
    x[3] = 0.75
    g[5] = b[5] = 0
    q, s, m, r = qm.ln_quantize_rowwise(*_t(x, g, b))
    np.testing.assert_allclose(r[3, 0].item(), 1 / np.sqrt(1e-5), rtol=1e-6)
    assert m[3, 0].item() == 0.75
    hq = np.clip(np.round(b / s[3, 0].item()), -127, 127)
    np.testing.assert_array_equal(q[3].numpy(), hq)
    assert not q[:, 5].any()


@pytest.mark.parametrize("K", [2048, 2064, 200])
def test_row10_routes_match_the_pallas_kernel(K):
    """Row 10's plain version on each of its kernel's routes (a warp a
    row at K = 2048, a block a row at 2064, the staged kernel at K % 16
    != 0) against ``_rowq_ln_call`` in interpret mode, with
    ``test_row10_matches_the_pallas_kernel``'s bars."""
    import jax.numpy as jnp
    from paddle_tpu.ops.quant_matmul import _rowq_ln_call
    dtype = "bfloat16" if K % 16 == 0 else "float32"
    x, g, b = _ln_inputs((16, K), K)
    ref = _rowq_ln_call(jnp.asarray(x).astype(dtype), jnp.asarray(g),
                        jnp.asarray(b), True)
    tx, tg, tb = _t(x, g, b)
    got = qm.ln_quantize_rowwise(tx.to(getattr(torch, dtype)), tg, tb)
    dq = np.abs(got[0].numpy().astype(np.int32) - np.asarray(ref[0], np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() <= 1e-3
    for a, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5)


def _row_sums_in_order(v):
    """Row sums of ``v [M, K]`` in the order row 10's register routes
    document (``csrc/quantize.cu``), in float32 numpy one add at a time:
    thread t of G keeps partials p[k] of values 4 i + k of its units
    (unit u * G + t: columns (u * G + t) * 16 ..), unit by unit, i by i;
    then (p0 + p1) + (p2 + p3); then the warp butterfly; then the warps
    in order."""
    M, K = v.shape
    G, nu = qm.row10_route(K)
    vp = np.zeros((M, nu * G * 16), np.float32)
    vp[:, :K] = v
    vp = vp.reshape(M, nu, G, 16)
    p = np.zeros((M, G, 4), np.float32)
    for u in range(nu):
        for j in range(16):
            p[:, :, j % 4] = p[:, :, j % 4] + vp[:, u, :, j]
    s = (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])
    lanes = s.reshape(M, G // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[..., :o] + lanes[..., o:2 * o]
    total = lanes[:, 0, 0]
    for w in range(1, G // 32):
        total = total + lanes[:, w, 0]
    return total[:, None]


def test_row10_sums_in_the_kernel_order():
    """The plain version's statistics are the kernel's, not torch's own
    reductions: they differ from ``x.mean()`` in the last bits on some
    rows (another summation order) and agree to 1e-5. They equal the
    documented order done one add at a time in numpy (a warp a row at K
    = 2048, a block a row of 160 threads at 2064); the order follows K:
    G and NU are ``row10_route(K)``."""
    assert qm.row10_route(2048) == (32, 4)
    assert qm.row10_route(2064) == (160, 1)
    assert qm.row10_route(16384) == (256, 4)
    assert qm.row10_route(16400) is None and qm.row10_route(200) is None
    for K in (2048, 2064):
        x, g, b = _ln_inputs((64, K), 2)
        _, _, m, r = qm.ln_quantize_rowwise(*_t(x, g, b))
        torch_mean = torch.from_numpy(x).mean(-1, keepdim=True)
        assert (m != torch_mean).any()
        np.testing.assert_allclose(m.numpy(), torch_mean.numpy(), rtol=1e-5,
                                   atol=1e-7)
        want_m = _row_sums_in_order(x) / np.float32(K)
        np.testing.assert_array_equal(m.numpy(), want_m)
        xc = x - want_m
        var = _row_sums_in_order(xc * xc) / np.float32(K)
        np.testing.assert_array_equal(
            r.numpy(), np.float32(1) / np.sqrt(var + np.float32(1e-5)))


@pytest.mark.parametrize("K", [256, 2064, 200])
def test_row10_row_alone_equals_row_in_a_batch(K):
    """The summation order follows K, not M: a row's codes, scale, mean
    and rstd are the same alone as among 47 other rows."""
    x, g, b = _ln_inputs((48, K), 12)
    tx, tg, tb = _t(x, g, b)
    batch = qm.ln_quantize_rowwise(tx, tg, tb)
    for i in (0, 31, 47):
        alone = qm.ln_quantize_rowwise(tx[i:i + 1], tg, tb)
        for a, w in zip(alone, batch):
            assert torch.equal(a, w[i:i + 1])


def _stats(x):
    _, m, r = ln_fwd(torch.from_numpy(x), torch.ones(x.shape[1]),
                     torch.zeros(x.shape[1]))
    return m, r


def test_row11_laws_against_the_reference_xla_path():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.quant_matmul import _sr_colq_xla
    x, g, b = _ln_inputs((64, 128), 3)
    g[9] = b[9] = 0                       # an all-zero column of h
    m, r = _stats(x)
    tx, tg, tb = _t(x, g, b)
    q, s = qm.sr_quantize_colwise_ln(tx, m, r, tg, tb, 11)
    h = ((tx - m) * r * tg + tb).numpy()
    _, rs = jax.jit(_sr_colq_xla)(jnp.asarray(h), jnp.int32(11))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
    v = h / s.numpy()
    qn = q.numpy().astype(np.float32)
    assert np.all((qn == np.floor(v)) | (qn == np.ceil(v)))
    assert s[0, 9].item() == np.float32(1 / 127) and not q[:, 9].any()
    assert q.t().is_contiguous()          # column-major, as row 12's


def test_row11_is_unbiased_over_seeds():
    n = 256
    x, g, b = _ln_inputs((16, 64), 4)
    m, r = _stats(x)
    tx, tg, tb = _t(x, g, b)
    h = ((tx - m) * r * tg + tb).double()
    acc = torch.zeros(x.shape, dtype=torch.float64)
    for seed in range(n):
        q, s = qm.sr_quantize_colwise_ln(tx, m, r, tg, tb, seed * 7919 + 5)
        acc += q.double() * s.double()
    err = (acc / n - h) / s.double()
    se = 0.5 / np.sqrt(n)
    assert err.abs().max().item() < 4 * se * np.sqrt(2 * np.log(x.size))
    assert abs(err.mean().item()) < 4 * se / np.sqrt(x.size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row11_fused_against_unfused_with_one_seed(dtype):
    """The fused and unfused wgrad quantizes of one activation draw the
    same words: bitwise with the same statistics; with the statistics
    of the port's LayerNorm (torch's reductions) within the reference's
    bars (``tests/test_quant_pallas.py:298-322``)."""
    x, g, b = _ln_inputs((48, 128), 5)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tg, tb = _t(g, b)
    m, r = qm.ln_quantize_rowwise(tx, tg, tb)[2:]
    fused = qm.sr_quantize_colwise_ln(tx, m, r, tg, tb, 23)
    same = qm.sr_quantize_colwise((tx.float() - m) * r * tg + tb, 23)
    assert torch.equal(fused[0], same[0]) and torch.equal(fused[1], same[1])
    h, _, _ = ln_fwd(tx.float(), tg, tb)
    q2, s2 = qm.sr_quantize_colwise(h, 23)
    np.testing.assert_allclose(fused[1].numpy(), s2.numpy(), rtol=1e-5)
    dq = (fused[0].int() - q2.int()).abs()
    assert dq.max() <= 1 and (dq != 0).float().mean() < 0.01


def _ref_vjps(fn, args, g, seeds, n_out):
    """The reference op's output and cotangents for each seed: one
    jitted value-and-vjp with the seed traced."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(args, seed):
        y, vjp = jax.vjp(lambda *a: fn(*a, seed), *args)
        return (y, *vjp(g))
    outs = []
    for s in seeds:
        out = run(tuple(jnp.asarray(a) for a in args), jnp.int32(s))
        outs.append([np.asarray(o) for o in out[:n_out + 1]])
    return outs


@pytest.mark.parametrize("fuse_bwd_colq", [True, False])
def test_ln_linear_all8_matches_the_reference_custom_vjp(fuse_bwd_colq):
    from paddle_tpu.ops import quant_matmul as ref
    x, g, b = _ln_inputs((128, 128), 6)
    x = x.reshape(2, 64, 128)
    rng = np.random.RandomState(7)
    w = (0.1 * rng.standard_normal((128, 96))).astype(np.float32)
    gy = rng.standard_normal((2, 64, 96)).astype(np.float32)
    seeds = (40503, 40503 * 7 + 1)
    refs = _ref_vjps(lambda x, g_, b_, w, s: ref.int8_ln_linear_all8(
        x, g_, b_, w, s, fuse_bwd_colq=fuse_bwd_colq), (x, g, b, w),
        gy, seeds, 4)
    tx, tg, tb, tw = (t.requires_grad_() for t in _t(x, g, b, w))
    y = qm.int8_ln_linear_all8(tx, tg, tb, tw, seeds[0], fuse_bwd_colq)
    y.backward(torch.from_numpy(gy))
    want = refs[0]
    for got, r in zip((y, tx.grad, tg.grad, tb.grad), want[:4]):
        assert _rel(got.detach().numpy(), r) < 2e-4
    spread = np.linalg.norm(refs[1][4] - want[4])
    assert 0 < np.linalg.norm(tw.grad.numpy() - want[4]) < 1.5 * spread


@pytest.mark.parametrize("tier", ["int8_linear", "int8_linear_dgrad8"])
def test_lower_tiers_match_the_reference_custom_vjp(tier):
    from paddle_tpu.ops import quant_matmul as ref
    rng = np.random.RandomState(8)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    w = (0.1 * rng.standard_normal((128, 96))).astype(np.float32)
    gy = rng.standard_normal((2, 64, 96)).astype(np.float32)
    (want,) = _ref_vjps(lambda x, w, s: getattr(ref, tier)(x, w), (x, w),
                        gy, (0,), 2)
    tx, tw = (t.requires_grad_() for t in _t(x, w))
    y = getattr(qm, tier)(tx, tw)
    y.backward(torch.from_numpy(gy))
    for got, r in zip((y, tx.grad, tw.grad), want):
        assert _rel(got.detach().numpy(), r) < 1e-5
    exact_dx = gy.reshape(-1, 96) @ w.T
    dx_err = _rel(tx.grad.numpy().reshape(-1, 128), exact_dx)
    assert (dx_err > 1e-4) == (tier == "int8_linear_dgrad8")


@pytest.mark.parametrize("vocab_major", [True, False])
def test_int8_cross_entropy_matches_the_reference(vocab_major):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.fused_ce import fused_softmax_cross_entropy as ref
    rng = np.random.RandomState(9)
    D, V = 128, 512
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    head = (0.1 * rng.standard_normal((V, D) if vocab_major else (D, V))
            ).astype(np.float32)
    labels = rng.randint(0, V, (2, 32))
    fn = jax.jit(jax.value_and_grad(lambda a, h: ref(
        a, h, jnp.asarray(labels), 4, True, vocab_major), argnums=(0, 1)))
    loss, (dx, dh) = fn(jnp.asarray(x), jnp.asarray(head))
    tx, th = (t.requires_grad_() for t in _t(x, head))
    got = fused_softmax_cross_entropy(tx, th, torch.from_numpy(labels), 4,
                                      int8=True, vocab_major=vocab_major)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), atol=1e-5)
    assert _rel(tx.grad.numpy(), dx) < 1e-5
    assert _rel(th.grad.numpy(), dh) < 1e-5
    exact = fused_softmax_cross_entropy(*_t(x, head),
                                        torch.from_numpy(labels), 4,
                                        vocab_major=vocab_major)
    assert 0 < abs(exact.item() - got.item()) < 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ln_kernels_match_plain_bit_for_bit(cuda, dtype):
    x, g, b = _ln_inputs((96, 2048), 10)
    x[4] = 1.5                            # variance 0
    g[7] = b[7] = 0                       # an all-zero column of LN(x)
    tx = torch.from_numpy(x).to(cuda, getattr(torch, dtype))
    tg, tb = (t.to(cuda) for t in _t(g, b))
    got = qm.ln_quantize_rowwise(tx, tg, tb)
    want = qm.ln_quantize_rowwise_plain(tx, tg, tb)
    m, r = want[2], want[3]
    got11 = qm.sr_quantize_colwise_ln(tx, m, r, tg, tb, 77)
    want11 = qm.sr_quantize_colwise_ln_plain(tx, m, r, tg, tb, 77)
    torch.cuda.synchronize()
    for a, w in zip((*got, *got11), (*want, *want11)):
        assert torch.equal(a, w)
    with pytest.raises(ValueError, match="multiple"):
        qm.ln_quantize_rowwise(tx[:, :-1].contiguous(), tg[:-1], tb[:-1])
    with pytest.raises(ValueError, match="values on"):
        qm.sr_quantize_colwise_ln(tx, m.cpu(), r, tg, tb, 77)


@pytest.mark.cuda
def test_cuda_row_kernel_takes_the_int8_ce_heads_vocab_rows(cuda):
    """``ce_int8`` row-quantizes the CE cotangent along the vocab (K =
    50304 at GPT-1.3B, a 197 KB row in shared memory): bitwise against
    the plain version; past the block's shared memory it raises."""
    x = torch.from_numpy(_ln_inputs((64, 50304), 11)[0]).to(
        cuda, torch.bfloat16)
    got, want = qm.quantize_rows(x), qm.quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="shared memory"):
        qm.quantize_rows(torch.zeros((16, 65536), device=cuda))


# row 10's routes, by K alone (``qm.row10_route``): a warp a row (K =
# 256, 2048), a block a row (2064, 16384), the staged kernel (16400; and
# 200, K % 16 != 0): each register route at its limit and one unit past
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [256, 2048, 2064, 16384, 16400, 200])
@pytest.mark.parametrize("M", [1, 16, 37])
def test_cuda_row10_routes_bit_for_bit(cuda, dtype, K, M):
    """Row 10 on every route at M = 1, 16 and an odd M: codes, scales,
    mean and rstd equal the plain version's, a constant row (variance 0)
    and a g = b = 0 column (codes 0) included."""
    x, g, b = _ln_inputs((M, K), K + M)
    x[M // 2] = 0.75
    g[5] = b[5] = 0
    tx = torch.from_numpy(x).to(cuda, getattr(torch, dtype))
    tg, tb = (t.to(cuda) for t in _t(g, b))
    before = qm.ln_quantize_rowwise.launches
    got = qm.ln_quantize_rowwise(tx, tg, tb)
    want = qm.ln_quantize_rowwise_plain(tx, tg, tb)
    torch.cuda.synchronize()
    assert qm.ln_quantize_rowwise.launches == before + 1
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert not got[0][:, 5].any() and got[2][M // 2, 0].item() == 0.75


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2048, 2064, 200])
def test_cuda_row10_row_alone_equals_row_in_a_batch(cuda, K):
    """The kernel's order follows K, not M: at the trainer's [6144, 2048]
    (and 512 rows at the other routes) the batch equals the plain
    version, and rows quantized alone equal their rows in the batch."""
    M = 6144 if K == 2048 else 512
    x, g, b = _ln_inputs((M, K), 13)
    tx = torch.from_numpy(x).to(cuda, torch.bfloat16)
    tg, tb = (t.to(cuda) for t in _t(g, b))
    batch = qm.ln_quantize_rowwise(tx, tg, tb)
    for a, w in zip(batch, qm.ln_quantize_rowwise_plain(tx, tg, tb)):
        assert torch.equal(a, w)
    for i in (0, 1001, M - 1):
        alone = qm.ln_quantize_rowwise(tx[i:i + 1], tg, tb)
        for a, w in zip(alone, batch):
            assert torch.equal(a, w[i:i + 1])


def _row11_cuda(R, C, dtype, seed, device):
    """Row 11's inputs on the card: x [R, C] of the trainer's kind with
    row 3 constant (variance 0), its rows' mean and rstd, g near 1 and b
    near 0 with column 5 at g = b = 0 (an all-zero column of LN(x))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(R, C, device=device, generator=gen)
         * (0.5 + 2 * torch.rand(R, 1, device=device, generator=gen))
         + torch.randn(R, 1, device=device, generator=gen)).to(dtype)
    x[3] = 0.75
    xf = x.float()
    mean = xf.mean(1, keepdim=True)
    rstd = torch.ones_like(mean) / torch.sqrt(
        xf.var(1, unbiased=False, keepdim=True) + 1e-5)
    g = 1 + 0.1 * torch.randn(C, device=device, generator=gen)
    b = 0.1 * torch.randn(C, device=device, generator=gen)
    g[5] = b[5] = 0
    return x, mean, rstd, g, b


# row 11's routes, by shape: the one-read cluster kernel up to
# qm.sr_cols_one_read_max_rows(dtype, ln=True) rows, the two-pass pair past
# it; at a small R, the trainer's 6144, the limit and 16 rows past it
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [32, 200, 2048])
@pytest.mark.parametrize("rows", ["16", "6144", "limit", "limit+16"])
def test_cuda_row11_routes_bit_for_bit(cuda, dtype, C, rows, monkeypatch):
    """Row 11 on the route its R picks equals the plain version and the
    two-pass pair at the same seed bit for bit (codes and scales), a
    constant row and a g = b = 0 column (codes 0) included; one wrapper
    launch, and R past the one-read limit takes the pair."""
    dt = getattr(torch, dtype)
    limit = qm.sr_cols_one_read_max_rows(dt, ln=True)
    R = {"16": 16, "6144": 6144, "limit": limit,
         "limit+16": limit + 16}[rows]
    x, mean, rstd, g, b = _row11_cuda(R, C, dt, C + R, cuda)
    pair = qm._cols_two_pass(x, None, 91, (mean, rstd, g, b))
    routes = []
    for name in ("_cols_one_read", "_cols_two_pass"):
        def counted(*args, _fn=getattr(qm, name), _name=name):
            routes.append(_name)
            return _fn(*args)
        monkeypatch.setattr(qm, name, counted)
    before = qm.sr_quantize_colwise_ln.launches
    got = qm.sr_quantize_colwise_ln(x, mean, rstd, g, b, 91)
    want = qm.sr_quantize_colwise_ln_plain(x, mean, rstd, g, b, 91)
    torch.cuda.synchronize()
    assert qm.sr_quantize_colwise_ln.launches == before + 1
    assert routes == ["_cols_one_read" if R <= limit else "_cols_two_pass"]
    for a, p, w in zip(got, pair, want):
        assert torch.equal(a, w) and torch.equal(p, w)
    assert got[0].stride() == (1, R)       # column-major codes
    assert not got[0][:, 5].any()
    assert torch.equal(got[1][0, 5], torch.tensor(1 / 127, device=cuda))
