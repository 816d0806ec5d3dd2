"""paddle_tpu_torch training BatchNorm (kernel row 15) against the
reference (``paddle_tpu.ops.bn_pallas.bn_train`` in Pallas interpret
mode on the CPU, and ``paddle_tpu.nn.BatchNorm2D``).

Inputs come from numpy seeds and go to both packages.

- (a) ``bn_train`` (its plain versions on the CPU) against the
  reference's ``bn_train(..., interpret=True)`` and its custom VJP: y,
  the batch mean and var, dx, dgamma and dbeta, relu on and off, f32
  and bf16, without affine, C = 12 (not a multiple of 8) and S = 1.
  Both take the f32 sums in another order, so f32 agrees to 2e-5
  (y, dx: magnitudes ~1-3; dgamma, dbeta: sums of up to 144 products,
  rtol 1e-5) and bf16 outputs within one bf16 step (atol=rtol=2^-7),
  their f32 statistics to 1e-5.
- (b) ``BatchNorm2D`` in training (three calls, then the running
  statistics), eval and ``use_global_stats`` against the reference's
  layer, f32 to 2e-5.
- On the card (marker ``cuda``): each kernel against its plain version
  at ragged and odd shapes in bf16, f16 and f32 (apply and dx bit for
  bit: the same rounded operations; the sums within 1e-5 relative: the
  same terms in another order), two runs the same bits, and one launch
  each per call.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import BatchNorm2D
from paddle_tpu_torch.ops import batch_norm as bn

BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_bn(x, gamma, beta, dy, relu, dtype):
    """The reference kernel's (y, mean, var) and (dx, dgamma, dbeta)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops.bn_pallas import bn_train
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x).astype(jdt)
    g = None if gamma is None else jnp.asarray(gamma)
    b = None if beta is None else jnp.asarray(beta)

    def f(xa, *wb):
        w_ = wb[0] if g is not None else None
        b_ = wb[1] if b is not None else None
        return bn_train(xa, w_, b_, 1e-5, relu, True)
    args = (xj,) + ((g, b) if g is not None else ())
    (y, mean, var), vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(dy).astype(jdt), jnp.zeros_like(mean),
                 jnp.zeros_like(var)))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return [f32(a) for a in (y, mean, var)], [f32(a) for a in grads]


@pytest.mark.parametrize("shape,dtype,relu,affine", [
    ((2, 16, 6, 6), "float32", False, True),
    ((2, 16, 6, 6), "float32", True, True),
    ((2, 16, 6, 6), "bfloat16", True, True),
    ((2, 16, 6, 6), "bfloat16", False, True),
    ((3, 12, 5, 1), "float32", False, False),   # C = 12, no affine
    ((8, 24), "float32", True, True),           # S = 1
])
def test_plain_bn_train_matches_reference(shape, dtype, relu, affine):
    rng = np.random.RandomState(sum(shape) + relu)
    C = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    gamma = (1 + 0.3 * rng.standard_normal(C)).astype(np.float32) \
        if affine else None
    beta = (0.2 * rng.standard_normal(C)).astype(np.float32) \
        if affine else None
    (ry, rmean, rvar), rgrads = _reference_bn(x, gamma, beta, dy, relu,
                                              dtype)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    gt = None if gamma is None else torch.from_numpy(gamma).requires_grad_()
    bt = None if beta is None else torch.from_numpy(beta).requires_grad_()
    launches = bn.bn_stats.launches
    y, mean, var = bn.bn_train(xt, gt, bt, 1e-5, relu)
    y.backward(torch.from_numpy(dy).to(tdt))
    assert bn.bn_stats.launches == launches        # CPU: plain versions
    assert y.dtype == tdt and mean.dtype == var.dtype == torch.float32
    tol = dict(atol=2e-5, rtol=1e-5) if dtype == "float32" \
        else dict(atol=BF16_STEP, rtol=BF16_STEP)
    np.testing.assert_allclose(mean.numpy(), rmean, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), rvar, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y.detach().float().numpy(), ry, **tol)
    np.testing.assert_allclose(xt.grad.float().numpy(), rgrads[0], **tol)
    if affine:
        for got, want in zip((gt.grad, bt.grad), rgrads[1:]):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5,
                                       rtol=2e-5 if dtype == "float32"
                                       else BF16_STEP)


def test_plain_kernels_compose_the_reference_vjp():
    """dgamma/dbeta/dx from the plain kernel functions and the [C] math
    equal autograd through the textbook BN (f32, 1e-5)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((4, 8, 7)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((4, 8, 7)).astype(np.float32))
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, g, b))
    mu = xs.mean((0, 2), keepdim=True)
    var = xs.var((0, 2), unbiased=False, keepdim=True)
    yref = torch.relu((xs - mu) / torch.sqrt(var + 1e-5) * gs.view(1, -1, 1)
                      + bs.view(1, -1, 1))
    yref.backward(dy)
    xk, gk, bk = (t.clone().requires_grad_() for t in (x, g, b))
    y, _, _ = bn.bn_train(xk, gk, bk, 1e-5, relu=True)
    y.backward(dy)
    for got, want in ((y, yref), (xk.grad, xs.grad), (gk.grad, gs.grad),
                      (bk.grad, bs.grad)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_stat_chunks_depend_only_on_the_shape():
    assert bn.stat_chunks(256, 64, 12544) == 17       # the stem: 17 chunks
    assert bn.stat_chunks(256, 2048, 49) == 1         # layer4: one
    assert bn.stat_chunks(2, 3, 1) == 1
    assert 1 <= bn.stat_chunks(10 ** 6, 1, 10 ** 3) <= 65535


def test_wrappers_refuse_mixed_devices_and_bad_shapes():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        bn.bn_apply(x, torch.ones(3).to("meta"), torch.zeros(3))
    with pytest.raises(ValueError):
        bn.bn_train(torch.zeros(3))


def _reference_layer(**kw):
    from paddle_tpu.nn import BatchNorm2D as RBatchNorm2D
    return RBatchNorm2D(6, **kw)


def _set(ref_layer, name, arr):
    import jax.numpy as jnp
    getattr(ref_layer, name)._data = jnp.asarray(arr)


@pytest.mark.parametrize("use_global_stats", [None, True])
def test_batchnorm2d_layer_matches_reference(use_global_stats):
    import paddle_tpu as paddle
    rng = np.random.RandomState(7)
    w = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    b = (0.1 * rng.standard_normal(6)).astype(np.float32)
    rm = (0.1 * rng.standard_normal(6)).astype(np.float32)
    rv = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    ref = _reference_layer(use_global_stats=use_global_stats)
    port = BatchNorm2D(6, use_global_stats=use_global_stats, device="cpu")
    for name, arr in (("weight", w), ("bias", b), ("_mean", rm),
                      ("_variance", rv)):
        _set(ref, name, arr)
        getattr(port, name).data.copy_(torch.from_numpy(arr))
    ref.train()
    port.train()
    for i in range(3):
        x = (rng.standard_normal((4, 6, 5, 3)) * (i + 1) + i) \
            .astype(np.float32)
        want = ref(paddle.to_tensor(x)).numpy()
        got = port(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)._data),
                                   atol=2e-5, rtol=1e-5)
    ref.eval()
    port.eval()
    x = rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               ref(paddle.to_tensor(x)).numpy(), atol=2e-5,
                               rtol=1e-5)


def test_batchnorm_layers_names_and_options():
    from paddle_tpu_torch.nn import BatchNorm1D, BatchNorm3D
    layer = BatchNorm2D(5, weight_attr=False, bias_attr=False, device="cpu")
    assert layer.weight is None and layer.bias is None
    assert sorted(layer.state_dict()) == ["_mean", "_variance"]
    assert BatchNorm1D(3, device="cpu")._data_format == "NCHW"
    assert BatchNorm3D(3, device="cpu")._data_format == "NCDHW"
    x = torch.randn(4, 3, 2, 2, 2)
    y = BatchNorm3D(3, device="cpu")(x)
    assert y.shape == x.shape
    with pytest.raises(NotImplementedError):
        BatchNorm2D(3, data_format="NHWC", device="cpu")(torch.zeros(
            2, 2, 2, 3))


def test_eval_branch_is_differentiable():
    """use_global_stats in training: the fixed-statistics apply gives the
    gradients of x * scale + shift (kernels 3 and 4 on the card)."""
    torch.manual_seed(0)
    layer = BatchNorm2D(4, use_global_stats=True, device="cpu")
    layer._variance.fill_(2.0)
    x = torch.randn(3, 4, 5, 5, requires_grad=True)
    layer(x, relu=True).sum().backward()
    scale = 1.0 / np.sqrt(2.0 + 1e-5)
    keep = (x.detach() > 0).float()
    torch.testing.assert_close(x.grad, keep * scale)
    torch.testing.assert_close(layer.bias.grad, keep.sum((0, 2, 3)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the BN kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,relu", [
    ((8, 64, 56, 56), torch.bfloat16, True),
    ((8, 64, 56, 56), torch.bfloat16, False),
    ((16, 2048, 7, 7), torch.bfloat16, True),     # S = 49: scalar loads
    ((5, 12, 3, 1), torch.float32, True),         # C = 12, S = 3
    ((33, 24), torch.float16, False),             # S = 1
    ((4, 256, 14, 14), torch.float32, False),
])
def test_cuda_kernels_match_plain_and_repeat(cuda, shape, dtype, relu):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = (torch.randn(shape, device=cuda, generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, device=cuda, generator=g).to(dtype)
    N, C = shape[:2]
    x3, dy3 = x.reshape(N, C, -1), dy.reshape(N, C, -1)
    scale = torch.rand(C, device=cuda, generator=g) + 0.5
    shift = torch.randn(C, device=cuda, generator=g)
    A, B, D = (torch.randn(C, device=cuda, generator=g) for _ in range(3))
    relu_from = (scale, shift) if relu else None
    before = [f.launches for f in (bn.bn_stats, bn.bn_apply, bn.bn_gsum,
                                   bn.bn_dx)]
    runs = [(bn.bn_stats(x3), bn.bn_apply(x3, scale, shift, relu),
             bn.bn_gsum(dy3, x3, relu_from),
             bn.bn_dx(dy3, x3, A, B, D, relu_from)) for _ in range(2)]
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(
        (bn.bn_stats, bn.bn_apply, bn.bn_gsum, bn.bn_dx), before)] == [2] * 4
    (s, y, gs, dx), (s2, y2, gs2, dx2) = runs
    for a, b in zip((*s, y, *gs, dx), (*s2, y2, *gs2, dx2)):
        assert torch.equal(a, b)                    # same bits
    assert torch.equal(y, bn.bn_apply_plain(x3, scale, shift, relu))
    assert torch.equal(dx, bn.bn_dx_plain(dy3, x3, A, B, D, relu_from))
    for got, want in zip((*s, *gs), (*bn.bn_stats_plain(x3),
                                     *bn.bn_gsum_plain(dy3, x3, relu_from))):
        scale_ = want.abs().max().clamp_min(1.0)
        torch.testing.assert_close(got / scale_, want / scale_, atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.cuda
def test_cuda_bn_layer_trains_through_the_kernels(cuda):
    """A bf16 BatchNorm2D forward and backward on the card launches each
    kernel once and holds to the CPU plain route (f32 sums in another
    order: one bf16 step)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(6, 32, 9, 9, device=cuda, generator=g).bfloat16()
    dy = torch.randn(6, 32, 9, 9, device=cuda, generator=g).bfloat16()
    outs = []
    for dev in (cuda, torch.device("cpu")):
        layer = BatchNorm2D(32, device=dev)
        xi = x.to(dev).detach().requires_grad_()
        before = bn.bn_dx.launches
        y = layer(xi, relu=True)
        y.backward(dy.to(dev))
        if dev.type == "cuda":
            assert bn.bn_dx.launches == before + 1
        outs.append([t.detach().float().cpu() for t in (
            y, xi.grad, layer.weight.grad, layer.bias.grad, layer._mean,
            layer._variance)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=BF16_STEP * 4,
                                   rtol=BF16_STEP)
