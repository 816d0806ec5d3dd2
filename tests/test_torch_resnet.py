"""paddle_tpu_torch ResNet-50 training and its layers against the
reference (``paddle_tpu``, JAX on the CPU).

Weights and inputs come from numpy seeds and go to both packages: the
reference's models are built with its initializers stubbed to zeros
(its jitted random draws take ~9 s to compile here), then loaded from
numpy, and the port's models come from the reference's ``state_dict()``
through ``models/convert.py``. A "reduced depth" ResNet-50 is
``ResNet(BottleneckBlock, 50)`` with each ``layerN`` cut to its first
block, on both sides.

- (c) ``conv2d`` (strides, int / pair / asymmetric / SAME padding,
  groups, bias), ``max_pool2d`` (ResNet's 3/2/1, ceil_mode),
  ``adaptive_avg_pool2d`` (divisible and not), ``Linear`` (Paddle's
  ``[in, out]`` weight) and ``cross_entropy`` (``ignore_index``, ``[N,
  1]`` labels, the reductions), f32, to 1e-5.
- (d) One ``TrainStep`` of the reduced ResNet-50 (batch 4, 40x40:
  layer4's BN sees 16 values a channel; at batch 2 and 32x32 it sees 2,
  and both packages' gradients blow up) under AMP O2 bf16 with
  Momentum, then two more:
  the step-0 loss, every gradient (the velocity after the first step is
  the gradient in the parameter's dtype, exactly, in both), the running
  statistics and every parameter after the step, and the 3-step loss
  trajectory. The dtype flow is the reference's: bf16 logits, f32 loss,
  bf16 conv and fc gradients, f32 BN gradients. bf16 tolerances: the
  loss within 2e-2 (bf16 logits), the running statistics within 2e-2
  of their norm, the gradients within 0.5 of their global norm: in bf16
  this network's gradients are mostly rounding noise of cancelling
  terms (the reference's own O2 gradients differ from a float64
  evaluation by 0.25-0.30 of the norm, measured while writing this
  test, and the port's by as much), the trajectory within 5e-2 a step.
  In f32 without AMP: the loss to 1e-5, the running statistics to
  1e-5, the gradients within 3e-2 of each one's norm (the reference's
  f32 gradients differ from float64 by 3e-3-1.2e-2, measured; the
  port's f32 gradients are held to the port's own float64 evaluation
  at 1e-4), the parameters after the step to 1e-3 (lr times that
  gradient difference), the trajectory to 1e-3. The parameters after
  the O2 step: 2e-2 (bf16).
- (e) The full-depth ``resnet50`` forward as the bench's inference
  phase runs it at its CPU smoke shape (batch 4, 32x32, eval mode, f32,
  the running statistics from numpy): logits to 1e-5 of their largest
  magnitude (the residual stream grows to ~1e3 over the 16 blocks; both
  packages are within 1e-6 of it from a float64 evaluation, measured).
- (f) The converter round trip (state and velocities) and its refusals.
- On the card (marker ``cuda``): a small ResNet-50 step launches each
  BN kernel exactly once per BatchNorm layer, 53, and nothing else.
"""
import contextlib
import copy

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp, jit, nn, optimizer
from paddle_tpu_torch.models.convert import (momentum_from_numpy,
                                             momentum_to_numpy,
                                             resnet_from_jax_state,
                                             resnet_state_to_numpy)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision.models import (BottleneckBlock, ResNet,
                                            resnet18, resnet50)

BATCH, HW = 4, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(model):
    for name in ("layer1", "layer2", "layer3", "layer4"):
        setattr(model, name, getattr(model, name)[0:1])
    return model


def _np_weights(shapes: dict, seed: int) -> dict:
    """Numpy weights for a ResNet state: Kaiming-uniform convs, a
    Xavier-normal fc, BN weights near 1, small biases, nontrivial running
    statistics."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if len(shape) == 4:
            lim = np.sqrt(6.0 / np.prod(shape[1:]))
            a = rng.uniform(-lim, lim, shape)
        elif len(shape) == 2:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / sum(shape))
        elif name.endswith("_variance"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith(".weight"):
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        out[name] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def reference():
    """Builds reference ResNets with its initializers stubbed to zeros
    (then loaded from numpy): ``build(full=False)``."""
    import jax.numpy as jnp
    from paddle_tpu.nn import initializer as I
    from paddle_tpu.vision.models.resnet import BottleneckBlock as RBlock
    from paddle_tpu.vision.models.resnet import ResNet as RResNet

    def zeros(self, shape, dtype):
        return jnp.asarray(np.zeros(shape, dtype))

    def build(seed: int, full: bool = False):
        with pytest.MonkeyPatch.context() as mp:
            for cls in (I.KaimingUniform, I.XavierNormal, I.Constant,
                        I.Uniform):
                mp.setattr(cls, "__call__", zeros)
            model = RResNet(RBlock, 50)
        if not full:
            _cut(model)
        state = model.state_dict()
        weights = _np_weights({k: tuple(v.shape) for k, v in state.items()},
                              seed)
        for k, v in state.items():
            v._data = jnp.asarray(weights[k])
        model.train()
        return model
    return build


def _np_state(ref_model) -> dict:
    return {k: np.asarray(v._data) for k, v in ref_model.state_dict().items()}


def _f32(a) -> np.ndarray:
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---- (c) layers ----

@pytest.mark.parametrize("stride,padding,groups,bias", [
    (1, 1, 1, False), (2, 3, 1, True), (2, [1, 2], 1, False),
    (1, [0, 1, 2, 1], 1, True), (2, "SAME", 1, False), (1, "VALID", 2, True),
])
def test_conv2d_matches_reference(stride, padding, groups, bias):
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as RF
    rng = np.random.RandomState(10 * stride + len(str(padding)) + groups)
    x = rng.standard_normal((2, 4, 9, 8)).astype(np.float32)
    w = rng.standard_normal((6, 4 // groups, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32) if bias else None
    want = RF.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                     None if b is None else paddle.to_tensor(b), stride,
                     padding, 1, groups).numpy()
    got = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   None if b is None else torch.from_numpy(b), stride,
                   padding, 1, groups)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_conv2d_layer_initialises_like_the_reference():
    layer = nn.Conv2D(8, 16, 3, bias_attr=False, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    limit = np.sqrt(2.0) * np.sqrt(3.0 / (8 * 9))
    w = layer.weight.detach()
    assert layer.bias is None and w.shape == (16, 8, 3, 3)
    assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit
    lin = nn.Linear(32, 10, device="cpu")
    assert lin.weight.shape == (32, 10) and torch.equal(
        lin.bias, torch.zeros(10))


@pytest.mark.parametrize("kind", ["resnet", "ceil", "adaptive",
                                  "adaptive_uneven"])
def test_pooling_matches_reference(kind):
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as RF
    rng = np.random.RandomState(len(kind))
    x = rng.standard_normal((2, 3, 11, 10)).astype(np.float32)
    xr, xt = paddle.to_tensor(x), torch.from_numpy(x)
    if kind == "resnet":
        want, got = RF.max_pool2d(xr, 3, 2, 1), F.max_pool2d(xt, 3, 2, 1)
    elif kind == "ceil":
        want = RF.max_pool2d(xr, 3, 2, 0, ceil_mode=True)
        got = F.max_pool2d(xt, 3, 2, 0, ceil_mode=True)
    elif kind == "adaptive":
        x = x[:, :, :10]
        want = RF.adaptive_avg_pool2d(paddle.to_tensor(x), (1, 1))
        got = F.adaptive_avg_pool2d(torch.from_numpy(x), (1, 1))
    else:
        want = RF.adaptive_avg_pool2d(xr, (3, 4))
        got = F.adaptive_avg_pool2d(xt, (3, 4))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_linear_and_cross_entropy_match_reference(reduction):
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as RF
    rng = np.random.RandomState(5)
    x = rng.standard_normal((6, 12)).astype(np.float32)
    w = rng.standard_normal((12, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    labels = np.array([0, 3, 6, -100, 2, 3], np.int64)
    logits_r = RF.linear(paddle.to_tensor(x), paddle.to_tensor(w),
                         paddle.to_tensor(b))
    logits_t = F.linear(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b))
    np.testing.assert_allclose(logits_t.numpy(), logits_r.numpy(),
                               atol=1e-5, rtol=1e-5)
    for lab in (labels, labels[:, None]):
        want = RF.cross_entropy(logits_r, paddle.to_tensor(lab),
                                reduction=reduction).numpy()
        got = nn.CrossEntropyLoss(reduction=reduction)(
            logits_t, torch.from_numpy(lab))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError):
        F.cross_entropy(logits_t, torch.from_numpy(labels),
                        label_smoothing=0.1)


# ---- (d) the reduced-depth training step ----

def _steps(reference, o2: bool):
    """The reference's and the port's reduced ResNet-50 after one
    TrainStep, then two more: (ref, port, records)."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    import paddle_tpu.nn as rnn
    from paddle_tpu.jit.functional import TrainStep as RTrainStep
    ref = reference(seed=11)
    ropt = paddle.optimizer.Momentum(learning_rate=0.01,
                                     parameters=ref.parameters())
    if o2:
        ref, ropt = paddle.amp.decorate(models=ref, optimizers=ropt,
                                        level="O2", dtype="bfloat16")
    # the velocities Momentum creates (zeros_like(p)), made here: the
    # reference's TrainStep would otherwise create them by an eager
    # sacrificial update (~4 s of op compiles on this CPU)
    for p in ref.parameters():
        ropt._accumulators[p.name] = {"velocity": jnp.asarray(
            np.zeros(p._data.shape, p._data.dtype))}
    port = resnet_from_jax_state(_np_state(ref), model=_cut(
        ResNet(BottleneckBlock, 50, device="cpu")))
    popt = optimizer.Momentum(learning_rate=0.01,
                              parameters=port.parameters())
    rng = np.random.RandomState(0)
    x = rng.rand(BATCH, 3, HW, HW).astype(np.float32)
    y = rng.randint(0, 1000, (BATCH,)).astype(np.int64)
    rstep = RTrainStep(ref, ropt, rnn.CrossEntropyLoss())
    pstep = jit.TrainStep(port, popt, nn.CrossEntropyLoss())
    rcast = (lambda: paddle.amp.auto_cast(level="O2", dtype="bfloat16")) \
        if o2 else contextlib.nullcontext
    pcast = (lambda: amp.auto_cast(level="O2", dtype="bfloat16")) \
        if o2 else contextlib.nullcontext
    with torch.no_grad(), pcast():
        logits_dtype = port(torch.from_numpy(x[:1])).dtype
    # that forward moved the running statistics: load them again
    port = resnet_from_jax_state(_np_state(ref), model=port)
    losses, rec = [], {}
    for i in range(3):
        with rcast():
            rl = float(rstep(paddle.to_tensor(x), paddle.to_tensor(y))
                       .numpy())
        with pcast():
            pl = float(pstep(torch.from_numpy(x), torch.from_numpy(y)))
        losses.append((rl, pl))
        if i == 0:
            # copies: the reference's next step donates these buffers
            named = dict(ref.named_parameters())
            rec["ref_vel"] = {n: ropt._accumulators[p.name]["velocity"]
                              for n, p in named.items()}
            rec["ref_vel_dtype"] = {n: v.dtype
                                    for n, v in rec["ref_vel"].items()}
            rec["ref_vel"] = {n: _f32(v) for n, v in rec["ref_vel"].items()}
            rec["port_vel"] = {n: popt._accumulators[p]["velocity"].clone()
                               for n, p in port.named_parameters()}
            rec["ref_state"] = {k: _f32(v) for k, v in
                                _np_state(ref).items()}
            rec["port_state"] = resnet_state_to_numpy(port)
    rec["losses"] = losses
    rec["logits_dtype"] = logits_dtype
    rec["x"], rec["y"] = x, y
    return ref, port, rec


@pytest.fixture(scope="module")
def o2_run(reference):
    return _steps(reference, o2=True)


@pytest.fixture(scope="module")
def f32_run(reference):
    return _steps(reference, o2=False)


def test_o2_step_dtype_flow_is_the_references(o2_run):
    import jax.numpy as jnp
    _, port, rec = o2_run
    assert rec["logits_dtype"] == torch.bfloat16
    for name, p in port.named_parameters():
        want = torch.float32 if rec["ref_vel_dtype"][name] == jnp.float32 \
            else torch.bfloat16
        assert p.dtype == want and rec["port_vel"][name].dtype == want, name
        is_bn = name.endswith(("bias", "weight")) and p.dim() == 1 \
            and not name.startswith("fc")
        assert (want == torch.float32) == is_bn, name
    for name, b in port.named_buffers():
        assert b.dtype == torch.float32, name


@pytest.mark.parametrize("run,loss_tol,stat_tol,grad_tol,traj_tol", [
    ("o2_run", 2e-2, 2e-2, 0.5, 5e-2),
    ("f32_run", 1e-5, 1e-5, 3e-2, 1e-3),
])
def test_reduced_resnet50_step_matches_reference(request, run, loss_tol,
                                                 stat_tol, grad_tol,
                                                 traj_tol):
    _, _, rec = request.getfixturevalue(run)
    (rl, pl) = rec["losses"][0]
    assert abs(rl - pl) <= loss_tol * max(1.0, abs(rl))
    names = list(rec["ref_vel"])
    ref_g = rec["ref_vel"]
    port_g = {n: rec["port_vel"][n].float().numpy() for n in names}
    if run == "o2_run":
        num = sum(np.linalg.norm(port_g[n] - ref_g[n]) ** 2 for n in names)
        den = sum(np.linalg.norm(ref_g[n]) ** 2 for n in names)
        assert np.sqrt(num / den) <= grad_tol
        assert _rel(port_g["fc.bias"], ref_g["fc.bias"]) <= 1e-2
    else:
        worst = max((_rel(port_g[n], ref_g[n]), n) for n in names)
        assert worst[0] <= grad_tol, worst
    for k, want in rec["ref_state"].items():
        got = rec["port_state"][k]
        tol = stat_tol if k.endswith(("_mean", "_variance")) else \
            (2e-2 if run == "o2_run" else 1e-3)
        assert _rel(got, want) <= tol, k
    for i, (rl, pl) in enumerate(rec["losses"]):
        assert abs(rl - pl) <= traj_tol * max(1.0, abs(rl)), (i, rl, pl)


def test_f32_gradients_match_float64():
    """The port's f32 gradients of the reduced ResNet-50 against its own
    float64 evaluation (the same function exactly): 1e-4 of each norm."""
    port = _cut(ResNet(BottleneckBlock, 50, device="cpu",
                       generator=torch.Generator().manual_seed(12)))
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.rand(BATCH, 3, HW, HW).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, (BATCH,)))

    def grads(model, dtype):
        model = copy.deepcopy(model).to(dtype)
        nn.CrossEntropyLoss()(model(x.to(dtype)), y).backward()
        return {n: p.grad.double() for n, p in model.named_parameters()}
    g32, g64 = grads(port, torch.float32), grads(port, torch.float64)
    for n in g64:
        assert (g32[n] - g64[n]).norm() <= 1e-4 * g64[n].norm(), n


# ---- (e) the full depth ----

def test_full_resnet50_forward_matches_reference(reference):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.jit.functional import functional_call
    ref = reference(seed=13, full=True)
    port = resnet_from_jax_state(_np_state(ref), device="cpu")
    ref.eval()
    port.eval()
    x = np.random.RandomState(2).rand(4, 3, 32, 32).astype(np.float32)
    params, buffers = ref.raw_state()
    fwd = jax.jit(lambda p, b, t: functional_call(ref, p, b, t)[0])
    want = np.asarray(fwd(params, buffers, jnp.asarray(x)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 1000)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---- (f) the converter ----

def test_converter_round_trip_and_refusals(o2_run):
    ref, port, _ = o2_run
    state = _np_state(ref)
    back = resnet_state_to_numpy(resnet_from_jax_state(
        state, model=_cut(ResNet(BottleneckBlock, 50, device="cpu"))))
    assert set(back) == set(state)
    for k, v in state.items():
        assert np.array_equal(back[k], _f32(v)), k
    opt = optimizer.Momentum(learning_rate=0.1,
                             parameters=port.parameters())
    vel = {n: np.full(p.shape, 0.5, np.float32)
           for n, p in port.named_parameters()}
    momentum_from_numpy(opt, port, vel)
    got = momentum_to_numpy(opt, port)
    assert all(np.array_equal(got[n], vel[n]) for n in vel)
    bad = dict(state)
    bad.pop("fc.bias")
    with pytest.raises(KeyError):
        resnet_from_jax_state(bad, model=_cut(ResNet(
            BottleneckBlock, 50, device="cpu")))
    bad = dict(state, **{"fc.bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        resnet_from_jax_state(bad, model=_cut(ResNet(
            BottleneckBlock, 50, device="cpu")))


def test_constructors_and_refusals():
    m = resnet18(device="cpu", num_classes=10)
    assert m(torch.rand(2, 3, 32, 32)).shape == (2, 10)
    assert sum(type(l).__name__ == "BatchNorm2D" for l in
               resnet50(device="cpu").modules()) == 53
    with pytest.raises(NotImplementedError):
        resnet50(pretrained=True, device="cpu")
    with pytest.raises(NotImplementedError):
        optimizer.Momentum(parameters=m.parameters(), weight_decay=1e-4)


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the BN kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_resnet50_step_launches_53_of_each(cuda):
    from paddle_tpu_torch.ops import batch_norm as bn
    from paddle_tpu_torch.ops import flash_attention as fa
    model = resnet50(device=cuda)
    opt = optimizer.Momentum(learning_rate=0.01,
                             parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2")
    step = jit.TrainStep(model, opt, nn.CrossEntropyLoss())
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(8, 3, 64, 64, device=cuda, generator=g)
    y = torch.randint(0, 1000, (8,), device=cuda, generator=g)
    kernels = (bn.bn_stats, bn.bn_apply, bn.bn_gsum, bn.bn_dx,
               fa.flash_attention_fwd, fa.flash_attention_bwd)
    before = [k.launches for k in kernels]
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        loss = step(x, y)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [53, 53, 53, 53, 0, 0]
