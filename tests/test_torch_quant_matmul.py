"""paddle_tpu_torch int8 quantize and all-int8 linears against the
reference (``paddle_tpu.ops.quant_matmul``, JAX on the CPU).

Inputs are made with numpy from a seed (a normal with per-column spread
over three decades, so per-row and per-column scales differ, with an
all-zero row and column) and handed to both packages.

- Kernel rows 8 and 9: the plain versions equal the Pallas kernels
  ``_rowq_call(x, True)`` and ``_colq_call(x, True)`` (interpret mode)
  bit for bit, codes and scales, in bf16 and f32. With the gelu fused
  (row 8), XLA's CPU tanh is not PyTorch's, so scales agree to 1e-6
  relative and codes within +-1 on at most 0.1% of elements.
- Kernel row 12 has no bitwise oracle (the TPU PRNG has no CPU
  lowering; the reference's CPU path ``_sr_colq_xla`` draws from
  ``jax.random``). Its plain version is held to that path's laws,
  jitted as the reference's step runs it: scales bit for bit, every
  code the floor or the ceiling of x / scale, the mean over 256 seeds
  within 4 standard errors of x, and scale 1/127 with codes 0 on an
  all-zero column. Its noise is Philox4x32-10, held to an independent
  Python implementation of the generator.
- Every scale is ``where(amax == 0, 1, amax) / 127`` as XLA compiles it
  (``* f32(1/127)``, in the jitted step and in the Pallas kernels in
  interpret mode alike); the eager reference divides, one ulp off on
  ~5% of rows.
- ``int8_linear_all8`` and ``int8_gelu_linear_all8`` against the
  reference's ``custom_vjp``: forward and dgrad are deterministic (RTN)
  and agree to f32 rounding (1e-6 relative; with gelu, the +-1 code
  differences above give 2e-3 of the norm). The wgrad draws other
  noise: its distance to the reference's is held within 1.5 times the
  reference's own seed-to-seed distance (1.8% of the gradient's norm,
  2.3% with gelu, at these shapes; the port's came out at 1.8% and
  2.4%), and its mean over seeds converges to the exact product.
- The seed derivation equals the reference's int32 arithmetic, wrap
  included.
- On the card (tests marked ``cuda``) every kernel equals its plain
  version bit for bit: row 8 at each of its routes (a warp a row, a
  block a row, the long rows of the int8 CE head, the decode shapes),
  rows 9 and 12 on both of their routes (one read of x on a
  thread-block cluster, and the two-pass pair past its row limit).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import quant_matmul as qm
from paddle_tpu_torch.ops.fused_adamw import philox_words


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed, zero_row=None, zero_col=None):
    rng = np.random.RandomState(seed)
    spread = 10.0 ** rng.uniform(-3, 0, shape[-1])
    x = (rng.standard_normal(shape) * spread).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0
    if zero_col is not None:
        x[:, zero_col] = 0
    return x


def _both(x, dtype):
    import jax.numpy as jnp
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_and_cols_match_pallas_kernels_bit_for_bit(dtype):
    from paddle_tpu.ops.quant_matmul import _colq_call, _rowq_call
    jx, tx = _both(_x((64, 256), 0, zero_row=5, zero_col=7), dtype)
    for ref, got in ((_rowq_call(jx, True), qm.quantize_rows(tx)),
                     (_colq_call(jx, True), qm.quantize_cols(tx))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    q, s = qm.quantize_rows(tx)
    assert q.dtype == torch.int8 and s.shape == (64, 1)
    assert s[5, 0].item() == np.float32(1 / 127) and not q[5].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cols_head_chunk_matches_pallas_kernel_bit_for_bit(dtype):
    """Row 9 at a head-chunk-like [D, Vc] (``ce_int8``'s untied head
    chunks): C not a multiple of 32, an all-zero column (scale 1/127,
    codes 0); codes and scales equal ``_colq_call``'s in interpret mode."""
    from paddle_tpu.ops.quant_matmul import _colq_call
    jx, tx = _both(_x((128, 200), 12, zero_col=33), dtype)
    ref = _colq_call(jx, True)
    q, s = qm.quantize_cols(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref[1]))
    assert s[0, 33].item() == np.float32(1 / 127) and not q[:, 33].any()
    assert q.t().is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_with_gelu_match_pallas_kernel(dtype):
    from paddle_tpu.ops.quant_matmul import _rowq_call
    jx, tx = _both(_x((64, 512), 1, zero_row=3), dtype)
    rq, rs = _rowq_call(jx, True, "gelu")
    q, s = qm.quantize_rows(tx, "gelu")
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(rq, np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() <= 1e-3


def test_rowwise_fast_dispatch_and_the_xla_form():
    """``quantize_rowwise_fast`` takes the row kernel over any leading
    dims and the column kernel on axis 0; both equal the reference's XLA
    form ``quantize_rowwise`` as the reference's jitted step computes it
    (XLA compiles ``/ 127`` into ``* f32(1/127)``)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.quant_matmul import quantize_rowwise
    ref = jax.jit(quantize_rowwise, static_argnums=1)
    x3 = _x((4, 16, 128), 2)
    w = _x((128, 64), 3)
    for x, axis in ((x3, -1), (w, 0)):
        q, s = qm.quantize_rowwise_fast(torch.from_numpy(x), axis)
        rq, rs = ref(jnp.asarray(x), axis)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    with pytest.raises(ValueError, match="no kernel"):
        qm.quantize_rowwise_fast(torch.from_numpy(x3), 1)


def _philox_reference(counter, key):
    """Philox4x32-10 in plain Python integers (Salmon et al., SC'11)."""
    m = 0xFFFFFFFF
    c, (k0, k1) = list(counter), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & m, p1 & m,
             ((p0 >> 32) ^ c[3] ^ k1) & m, p0 & m]
    return c


@pytest.mark.parametrize("key,key_hi,stream", [
    (0, 0, 0), (0xDEADBEEF, 1, 0), (12345, 0, 1), (2 ** 32 - 1, 0, 2)])
def test_philox_words_match_the_generator(key, key_hi, stream):
    """The words the SR quantize (key (seed, 1)) and the int8-moment
    AdamW (streams 1, 2) draw, element e taking word e % 4 of counter
    (e // 4, 0, stream, 0)."""
    n = 4 * 70
    got = philox_words(n, key, "cpu", key_hi=key_hi, stream=stream).tolist()
    for e in (0, 1, 2, 3, 4, 101, n - 1):
        want = _philox_reference((e // 4, 0, stream, 0), (key, key_hi))
        assert got[e] == want[e % 4]


def test_sr_colwise_laws_against_the_reference_xla_path():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.quant_matmul import _sr_colq_xla
    x = _x((64, 128), 4, zero_col=9)
    tx = torch.from_numpy(x)
    rq, rs = jax.jit(_sr_colq_xla)(jnp.asarray(x), jnp.int32(11))
    q, s = qm.sr_quantize_colwise(tx, 11)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    v = x / s.numpy()
    qn = q.numpy().astype(np.float32)
    assert np.all((qn == np.floor(v)) | (qn == np.ceil(v)))
    assert s[0, 9].item() == np.float32(1 / 127) and not q[:, 9].any()
    # the reference's codes obey the same law with other noise
    rqn = np.asarray(rq, np.float32)
    assert np.all((rqn == np.floor(v)) | (rqn == np.ceil(v)))
    assert not np.array_equal(qn, rqn)
    # column-major codes: the layout the int8 GEMM takes at full rate
    assert q.t().is_contiguous()


def test_sr_colwise_gelu_scales_match_the_reference():
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.quant_matmul import _sr_colq_xla
    x = _x((64, 128), 5)
    _, rs = jax.jit(_sr_colq_xla, static_argnums=2)(
        jnp.asarray(x), jnp.int32(3), "gelu")
    _, s = qm.sr_quantize_colwise(torch.from_numpy(x), 3, act="gelu")
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)


def test_sr_colwise_is_unbiased_over_seeds():
    """256 seeds: the mean of q * scale is x within 4 standard errors
    (one draw's error is within one step: sd <= scale / 2), over the
    whole tensor and elementwise."""
    n = 256
    x = torch.from_numpy(_x((32, 64), 6))
    acc = torch.zeros(x.shape, dtype=torch.float64)
    for seed in range(n):
        q, s = qm.sr_quantize_colwise(x, seed * 7919 + 5)
        acc += (q.double() * s.double())
    err = (acc / n - x.double()) / s.double()
    se = 0.5 / np.sqrt(n)
    assert err.abs().max().item() < 4 * se * np.sqrt(2 * np.log(x.numel()))
    assert abs(err.mean().item()) < 4 * se / np.sqrt(x.numel())


def _ref_grads(fn, x, w, g, seeds):
    """(y, dx, dw) of the reference op for each seed: one jitted
    value-and-vjp, the seed a traced int32."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(x, w, seed):
        y, vjp = jax.vjp(lambda x, w: fn(x, w, seed), x, w)
        return (y, *vjp(g))
    return [tuple(np.asarray(a) for a in run(jnp.asarray(x), jnp.asarray(w),
                                             jnp.int32(s))) for s in seeds]


@pytest.mark.parametrize("gelu", [False, True])
def test_all8_linears_match_the_reference_custom_vjp(gelu):
    from paddle_tpu.ops import quant_matmul as ref
    rng = np.random.RandomState(7)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    w = (0.1 * rng.standard_normal((128, 96))).astype(np.float32)
    g = rng.standard_normal((2, 64, 96)).astype(np.float32)
    fn = ref.int8_gelu_linear_all8 if gelu else ref.int8_linear_all8
    seeds = (40503, 40503 * 7 + 1)
    refs = _ref_grads(fn, x, w, g, seeds)
    port_fn = qm.int8_gelu_linear_all8 if gelu else qm.int8_linear_all8
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = port_fn(tx, tw, seeds[0])
    y.backward(torch.from_numpy(g))
    y_ref, dx_ref, dw_ref = refs[0]
    for got, want in ((y.detach().numpy(), y_ref), (tx.grad.numpy(), dx_ref)):
        if gelu:      # a few +-1 codes of gelu(x) (XLA's tanh vs torch's)
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel < 2e-3, rel
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
    spread = np.linalg.norm(refs[1][2] - dw_ref)
    assert spread > 0
    assert np.linalg.norm(tw.grad.numpy() - dw_ref) < 1.5 * spread
    # the wgrad is unbiased: 16 seeds' mean is closer to exact than one
    a = (0.5 * x * (1 + np.tanh(0.7978845608028654
                                * (x + 0.044715 * x ** 3)))) if gelu else x
    exact = a.reshape(-1, 128).T.astype(np.float64) @ g.reshape(-1, 96)
    mean = np.zeros_like(exact)
    for s in range(16):
        xx = torch.from_numpy(x).requires_grad_()
        ww = torch.from_numpy(w).requires_grad_()
        port_fn(xx, ww, s).backward(torch.from_numpy(g))
        mean += ww.grad.numpy() / 16
    one = np.linalg.norm(tw.grad.numpy() - exact)
    assert np.linalg.norm(mean - exact) < 0.5 * one


def test_seed_derivation_matches_reference_int32():
    import jax.numpy as jnp
    from paddle_tpu.ops.quant_matmul import site_seed
    for step in (0, 1, 53021, 53022, 10 ** 6, 2 ** 31 - 2):
        sr = (jnp.int32(step) + jnp.int32(1)) * jnp.int32(40503)
        assert qm.step_seed(step) == int(sr)
        for li in (0, 1, 23):
            ls = sr + jnp.int32(li * 16)
            assert qm.layer_seed(qm.step_seed(step), li) == int(ls)
            for site in (1, 2, 3):
                ss = site_seed(ls, site)
                assert qm.site_seed(int(ls), site) == int(ss)
                base = ss * jnp.int32(1000003)
                assert qm.wgrad_seeds(int(ss)) == (
                    int(base + jnp.int32(7919)),
                    int(base + jnp.int32(104729)))
    assert qm.step_seed(53021) < 0      # (53022 * 40503) wraps past 2**31
    assert qm.layer_seed(None, 2) == 33 and qm.site_seed(None, 3) == 11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


# row 8's routes (csrc/quantize.cu, picked from the shape): a block a
# row (K = 8192; the decode shapes M = 1, 8 at K = 5504 and 2048), a warp
# a row (M >= 1024, K <= 2048), and the rows staged in shared memory (K
# = 50304, the int8 CE head's; K = 200, not a multiple of 16)
ROW8_SHAPES = [(96, 200), (96, 8192), (1, 5504), (8, 2048), (1024, 2048),
               (1024, 128), (3, 50304)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("shape", ROW8_SHAPES)
def test_cuda_kernels_match_plain_bit_for_bit(cuda, dtype, gelu, shape):
    """Rows 8, 9 and 12 against their plain versions, an all-zero row
    and column included: row 8 at every route, the column kernels where
    the rows are a multiple of 16."""
    zero_row = shape[0] // 2 if shape[0] > 1 else None
    x = torch.from_numpy(_x(shape, 8, zero_row=zero_row, zero_col=5)).to(
        cuda, getattr(torch, dtype))
    act = "gelu" if gelu else None
    before = qm.quantize_rows.launches
    pairs = [(qm.quantize_rows(x, act), qm.quantize_rows_plain(x, act))]
    assert qm.quantize_rows.launches == before + 1
    if shape[0] % 16 == 0:
        pairs.append((qm.sr_quantize_colwise(x, 77, act),
                      qm.sr_quantize_colwise_plain(x, 77, act)))
        if not gelu:
            pairs.append((qm.quantize_cols(x), qm.quantize_cols_plain(x)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="multiple"):
        qm.quantize_rows(x[:, :-1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("R", [16, 64, 6144])
@pytest.mark.parametrize("C", [64, 2048])
def test_cuda_one_read_sr_cols_match_plain_bit_for_bit(cuda, dtype, gelu,
                                                       R, C):
    """Row 12's one-read cluster kernel (every R here is within its
    limit): codes and scales equal the plain version's, an all-zero
    column included (scale 1/127, codes 0)."""
    x = torch.from_numpy(_x((R, C), R + C, zero_col=C // 3)).to(
        cuda, getattr(torch, dtype))
    act = "gelu" if gelu else None
    assert R <= qm.sr_cols_one_read_max_rows(x.dtype, act)
    before = qm.sr_quantize_colwise.launches
    got = qm.sr_quantize_colwise(x, 1234 + R, act)
    want = qm.sr_quantize_colwise_plain(x, 1234 + R, act)
    torch.cuda.synchronize()
    assert qm.sr_quantize_colwise.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[0][:, C // 3] == 0).all())
    assert got[1][0, C // 3].item() == np.float32(1 / 127)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,gelu", [("float32", True),
                                        ("bfloat16", False)])
def test_cuda_sr_cols_both_routes_at_the_limit(cuda, dtype, gelu):
    """At the one-read route's row limit and 16 rows past it (the
    two-pass pair, picked by shape before the launch) the codes and
    scales equal the plain version's."""
    act = "gelu" if gelu else None
    limit = qm.sr_cols_one_read_max_rows(getattr(torch, dtype), act)
    assert limit % 16 == 0
    for R in (limit, limit + 16):
        x = torch.from_numpy(_x((R, 64), 11, zero_col=7)).to(
            cuda, getattr(torch, dtype))
        got = qm.sr_quantize_colwise(x, 99, act)
        want = qm.sr_quantize_colwise_plain(x, 99, act)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# row 9 (``quantize_cols``) in one read: the trainer's weights (wqkv,
# win, wout), a head-chunk-like [D, Vc] with C not a multiple of 32, a
# few rows and columns; the int8 CE head's tied [50304, 2048] is past the
# one-read limit (the two-pass pair)
COL9_SHAPES = [(2048, 6144), (2048, 8192), (8192, 2048), (2048, 200),
               (16, 64), (16, 8), (50304, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", COL9_SHAPES)
def test_cuda_cols_match_plain_bit_for_bit(cuda, dtype, shape):
    """Row 9's codes and scales equal the plain version's, an all-zero
    column included (scale 1/127, codes 0), one launch a call."""
    R, C = shape
    x = torch.from_numpy(_x(shape, R + C, zero_col=C // 3)).to(
        cuda, getattr(torch, dtype))
    before = qm.quantize_cols.launches
    got, want = qm.quantize_cols(x), qm.quantize_cols_plain(x)
    torch.cuda.synchronize()
    assert qm.quantize_cols.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].t().is_contiguous()
    assert bool((got[0][:, C // 3] == 0).all())
    assert got[1][0, C // 3].item() == np.float32(1 / 127)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_cols_both_routes_at_the_limit(cuda, dtype):
    """At row 9's one-read row limit and 16 rows past it (the two-pass
    pair, picked by shape before the launch) the codes and scales equal
    the plain version's."""
    limit = qm.cols_one_read_max_rows(getattr(torch, dtype))
    assert limit % 16 == 0
    for R in (limit, limit + 16):
        x = torch.from_numpy(_x((R, 64), 13, zero_col=7)).to(
            cuda, getattr(torch, dtype))
        got, want = qm.quantize_cols(x), qm.quantize_cols_plain(x)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
