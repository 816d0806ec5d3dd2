"""paddle_tpu_torch int8-moment AdamW (kernel row 13) against the
reference (``paddle_tpu.ops.fused_adamw``, JAX on the CPU).

- ``moment8_eligible``, ``moment8_init`` and ``moment8_unpack`` equal
  the reference's, eligibility at every GPT-1.3B leaf shape (it needs
  only shapes), so both packages keep int8 moments on the same leaves.
- The update: the reference's ``fused_adamw_update8`` draws from the TPU
  PRNG, which has no CPU lowering, so its oracle is the reference's
  ``fused_adamw_update(..., stoch_round=False, interpret=True)`` on the
  dequantized f32 moments. That kernel calls no PRNG and gives the p2,
  m2 and v2 that row 13 then quantizes, within row 14's bar of
  ``tests/test_torch_fused_adamw.py`` (1-2 ulp: interpret mode
  associates f32 ops differently; ``rtol=1e-6, atol=1e-7``) of the
  port's row-14 plain version on the same inputs, which runs row 13's
  f32 operations in its order. Against that exact update: p bit for
  bit, the new scales of m2 and sqrt(v2) bit for bit (``where(amax ==
  0, 1, amax) / 127`` as XLA compiles it: ``* f32(1/127)``), every code
  the floor or the ceiling of its value over its scale (m codes in
  [-127, 127], sqrt(v) codes in [0, 127]), and the codes' mean over 128
  seeds within 4 standard errors of the value.
- With stochastic rounding on, p's bits equal the bf16-moment kernel's
  (row 14) for the same step and leaf: the two share Philox stream 0.
- The list entry ``fused_adamw_update8_leaves``, and an ``AdamW8Leaves``
  table kept over two steps with new gradient tensors, give each leaf
  (C 128 to 8192, a leaf of one row, a 3-D leaf) bit for bit what the
  per-leaf plain version gives it; a kept table no longer holds a leaf
  whose storage was swapped.
- On the card (tests marked ``cuda``) the kernel equals the plain
  version bit for bit: one leaf, and lists of every (p, g) dtype pair
  kept over two steps in one launch a step, with a row past the 8192
  elements a thread keeps in registers, zeros and values too small for
  the fast division.
"""
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.fused_adamw import (AdamW8Leaves,
                                              fused_adamw_update,
                                              fused_adamw_update8,
                                              fused_adamw_update8_leaves,
                                              fused_adamw_update8_plain,
                                              moment8_eligible, moment8_init,
                                              moment8_unpack)

HP = dict(lr=3e-4, wd=0.1, b1=0.9, b2=0.95, eps=1e-8)
STEP = 7
# GPT-1.3B's leaf shapes (bench.py:build_flagship): wqkv, wproj, win, wout
# of a layer, wte, wpe, and the 1-D gains and biases
GPT_1P3B_SHAPES = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048),
                   (50304, 2048), (1024, 2048), (2048,), (6144,), (8192,)]
EDGE_SHAPES = [(64, 384), (8, 128), (7, 128), (8, 100), (255, 256),
               (4, 16, 1024), (16, 32768), (8, 65536), (128, 512)]
# the list entry's leaves: C from 128 to 8192, a leaf of one row, a 3-D
# leaf ([8, 256] codes), and their SR streams
LIST_SHAPES = [(24, 128), (8, 2048), (1, 2048), (8, 8192), (2, 4, 256)]
LIST_IDS = [3, 40, 7, 0, 91]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scalars(scale=0.5, step=STEP):
    b1, b2 = np.float32(HP["b1"]), np.float32(HP["b2"])
    t, one = np.float32(step), np.float32(1)
    return np.array([scale, one / (one - b1 ** t), one / (one - b2 ** t),
                     1.0], np.float32)


def _state(shape, seed):
    """p, g and int8 moment state of the kind a few steps leave: codes
    over their range, per-row scales over two decades, a zero row."""
    rng = np.random.RandomState(seed)
    R, C = shape
    p = rng.standard_normal(shape).astype(np.float32)
    g = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    mq = rng.randint(-127, 128, shape).astype(np.int8)
    vq = rng.randint(0, 128, shape).astype(np.int8)
    msc = (10.0 ** rng.uniform(-4, -2, (R, 1))).astype(np.float32)
    vsc = (10.0 ** rng.uniform(-4, -2, (R, 1))).astype(np.float32)
    if R > 3:
        g[3] = 0
        mq[3] = 0
        vq[3] = 0
    return p, g, mq, msc, vq, vsc


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def test_eligibility_matches_reference_on_every_shape():
    from paddle_tpu.ops import fused_adamw as ref
    for shape in GPT_1P3B_SHAPES + EDGE_SHAPES:
        fake = types.SimpleNamespace(shape=shape, ndim=len(shape),
                                     size=int(np.prod(shape)))
        assert moment8_eligible(shape) == ref.moment8_eligible(fake), shape
    # at GPT-1.3B: every 2-D leaf (4 per layer, wte, wpe), no 1-D one
    assert [moment8_eligible(s) for s in GPT_1P3B_SHAPES] == \
        [True] * 6 + [False] * 3


def test_init_and_unpack_match_reference():
    import jax.numpy as jnp
    from paddle_tpu.ops import fused_adamw as ref
    for got, want in zip(moment8_init(torch.zeros(64, 384)),
                         ref.moment8_init(jnp.zeros((64, 384)))):
        assert got.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, _, mq, msc, vq, vsc = _state((64, 384), seed=0)
    got = moment8_unpack(*_torch(mq, msc, vq, vsc), (64, 384))
    want = ref.moment8_unpack(*(jnp.asarray(a) for a in (mq, msc, vq, vsc)),
                              (64, 384))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def oracle():
    """The update row 13 must quantize, twice: the reference's exact
    (no-PRNG) kernel on the dequantized moments, and the port's row-14
    plain version on the same (the f32 operations row 13 runs, in its
    order); the two agree within row 14's bar."""
    import jax.numpy as jnp
    from paddle_tpu.ops import fused_adamw as ref
    p, g, mq, msc, vq, vsc = _state((64, 384), seed=1)
    m = mq.astype(np.float32) * msc
    s = vq.astype(np.float32) * vsc
    sc = _scalars()
    want = ref.fused_adamw_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(s * s),
        sc[0], sc[1], sc[2], STEP, **HP, stoch_round=False, interpret=True,
        lr_scale=sc[3])
    exact = fused_adamw_update(*_torch(p, g, m, s * s), torch.from_numpy(sc),
                               **HP)
    for a, b in zip(exact, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    return {"state": (p, g, mq, msc, vq, vsc),
            **{k: t.numpy() for k, t in zip(("p2", "m2", "v2"), exact)}}


def _update8(state, seed=STEP, leaf_id=3, **kw):
    tensors = _torch(*state)
    before = fused_adamw_update8.launches
    out = fused_adamw_update8(*tensors, torch.from_numpy(_scalars()), **HP,
                              seed=seed, leaf_id=leaf_id, **kw)
    assert fused_adamw_update8.launches == before      # CPU: plain version
    assert all(a is b for a, b in zip(out, tensors[:1] + tensors[2:]))
    return [t.numpy() for t in out]


def test_update_matches_the_reference_oracle(oracle):
    p, mq, msc, vq, vsc = _update8(oracle["state"])
    np.testing.assert_array_equal(p, oracle["p2"])
    m2, s2 = oracle["m2"], np.sqrt(oracle["v2"])
    for q, scale, value, lo in ((mq, msc, m2, -127), (vq, vsc, s2, 0)):
        amax = np.abs(value).max(1, keepdims=True)
        want = np.where(amax == 0, np.float32(1), amax) \
            * np.float32(1 / 127)
        np.testing.assert_array_equal(scale, want)
        v = value / scale
        qf = q.astype(np.float32)
        assert q.dtype == np.int8 and qf.min() >= lo and qf.max() <= 127
        assert np.all((qf == np.clip(np.floor(v), lo, 127))
                      | (qf == np.clip(np.ceil(v), lo, 127)))
    # the zero row: g = 0 and m = v = 0 give m2 = v2 = 0, scale 1/127
    assert msc[3, 0] == vsc[3, 0] == np.float32(1 / 127)
    assert not mq[3].any() and not vq[3].any()


def test_requantization_is_unbiased_over_seeds(oracle):
    n = 128
    acc_m = np.zeros(oracle["m2"].shape)
    acc_s = np.zeros(oracle["m2"].shape)
    for seed in range(n):
        _, mq, msc, vq, vsc = _update8(oracle["state"], seed=seed * 31 + 1)
        acc_m += mq.astype(np.float64) * msc
        acc_s += vq.astype(np.float64) * vsc
    for acc, value, scale in ((acc_m, oracle["m2"], msc),
                              (acc_s, np.sqrt(oracle["v2"]), vsc)):
        err = (acc / n - value) / scale        # in steps of the scale
        se = 0.5 / np.sqrt(n)
        assert np.abs(err).max() < 4 * se * np.sqrt(2 * np.log(err.size))
        assert abs(err.mean()) < 4 * se / np.sqrt(err.size)


def test_master_sr_bits_equal_the_bf16_moment_kernel():
    p, g, mq, msc, vq, vsc = _state((64, 384), seed=2)
    tp = torch.from_numpy(p).bfloat16()
    m, v = moment8_unpack(*_torch(mq, msc, vq, vsc), (64, 384))
    sc = torch.from_numpy(_scalars())
    kw = dict(HP, stoch_round=True, seed=STEP, leaf_id=5)
    row14 = fused_adamw_update(tp.clone(), torch.from_numpy(g), m, v, sc,
                               **kw)[0]
    row13 = fused_adamw_update8(tp.clone(), torch.from_numpy(g),
                                *_torch(mq, msc, vq, vsc), sc, **kw)[0]
    assert row13.dtype == torch.bfloat16 and torch.equal(row13, row14)
    assert not torch.equal(row13, tp)


def _list_leaves(shapes, device="cpu", p_dtype=torch.bfloat16,
                 g_dtype=torch.bfloat16, seed=10):
    """Leaves ``(p, g, (m_q, m_scale), (v_q, v_scale))`` of ``shapes``
    (codes ``[R, C]`` with C the last dim), each with elements whose m2
    and v2 come out 0 and elements whose m2 and sqrt(v2) fall below the
    fast division's range (g 1e-20, codes 0)."""
    out = []
    for i, shape in enumerate(shapes):
        C = shape[-1]
        p, g, mq, msc, vq, vsc = _state((int(np.prod(shape)) // C, C),
                                        seed + i)
        g[:, ::7], mq[:, ::7], vq[:, ::7] = 0, 0, 0
        g[:, 5::13], mq[:, 5::13], vq[:, 5::13] = 1e-20, 0, 0
        p, g, mq, msc, vq, vsc = (t.to(device) for t in _torch(
            p, g, mq, msc, vq, vsc))
        out.append((p.reshape(shape).to(p_dtype),
                    g.reshape(shape).to(g_dtype), (mq, msc), (vq, vsc)))
    return out


def _copies(leaves):
    return [(p.clone(), g, tuple(t.clone() for t in m),
             tuple(t.clone() for t in v)) for p, g, m, v in leaves]


def _assert_leaves_equal(got, want):
    for k, ((p, _, m, v), (wp, _, wm, wv)) in enumerate(zip(got, want)):
        for name, a, b in zip(("p", "m_q", "m_scale", "v_q", "v_scale"),
                              (p, *m, *v), (wp, *wm, *wv)):
            assert torch.equal(a, b), f"leaf {k}: {name} differs"


def _kept_steps(leaves, ids, sc, kw, steps=2):
    """An ``AdamW8Leaves`` kept over ``steps`` steps (new gradient
    tensors and seed each step) and the per-leaf plain version, on
    copies of ``leaves``; returns (kept, plain, the table's launches)."""
    kept, plain = _copies(leaves), _copies(leaves)
    ps, _, ms, vs = zip(*kept)
    table = AdamW8Leaves(ps, ms, vs, ids)
    assert table.holds(ps, ms, vs)
    assert not table.holds([p for p, *_ in plain], ms, vs)
    before = fused_adamw_update8.launches
    for step in range(steps):
        grads = [g * (1 + step) for _, g, _, _ in leaves]
        args = dict(kw, seed=kw["seed"] + step)
        table.update(grads, sc, **args)
        for (p, _, m, v), g, i in zip(plain, grads, ids):
            fused_adamw_update8_plain(p, g, *m, *v, sc, leaf_id=i, **args)
    return kept, plain, fused_adamw_update8.launches - before


def test_list_entry_and_kept_table_equal_per_leaf_plain():
    leaves = _list_leaves(LIST_SHAPES)
    sc = torch.from_numpy(_scalars())
    kw = dict(HP, stoch_round=True, seed=STEP)
    got = _copies(leaves)
    before = fused_adamw_update8.launches
    fused_adamw_update8_leaves(*map(list, zip(*got)), sc, LIST_IDS, **kw)
    assert fused_adamw_update8.launches == before         # CPU: plain
    want = _copies(leaves)
    for (p, g, m, v), i in zip(want, LIST_IDS):
        fused_adamw_update8_plain(p, g, *m, *v, sc, leaf_id=i, **kw)
    _assert_leaves_equal(got, want)
    assert not torch.equal(got[0][0], leaves[0][0])
    kept, plain, launches = _kept_steps(leaves, LIST_IDS, sc, kw)
    assert launches == 0
    _assert_leaves_equal(kept, plain)
    # the kept table holds addresses: a swapped storage is not held
    ps, _, ms, vs = zip(*kept)
    table = AdamW8Leaves(ps, ms, vs, LIST_IDS)
    ps[1].data = ps[1].data.clone()
    assert not table.holds(ps, ms, vs)
    with pytest.raises(ValueError, match="one length"):
        fused_adamw_update8_leaves(list(ps), [], list(ms), list(vs), sc,
                                   LIST_IDS, **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype,sr", [("bfloat16", True),
                                        ("float32", False)])
def test_cuda_kernel_matches_plain_bit_for_bit(cuda, p_dtype, sr):
    state = [t.to(cuda) for t in _torch(*_state((96, 1152), seed=4))]
    state[0] = state[0].to(getattr(torch, p_dtype))
    state[1] = state[1].to(getattr(torch, p_dtype))
    sc = torch.from_numpy(_scalars()).to(cuda)
    kw = dict(HP, stoch_round=sr, leaf_id=9, seed=STEP)
    want = fused_adamw_update8_plain(*[t.clone() for t in state], sc, **kw)
    before = fused_adamw_update8.launches
    got = fused_adamw_update8(*state, sc, **kw)
    torch.cuda.synchronize()
    assert fused_adamw_update8.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype,g_dtype", [
    ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
    ("float32", "bfloat16"), ("float32", "float32")])
def test_cuda_list_kernel_matches_plain_bit_for_bit(cuda, p_dtype, g_dtype):
    """The trainer's way on the card: an ``AdamW8Leaves`` kept over two
    steps, one launch a step, SR on with a bf16 p; a row of 16384 takes
    the steps past the 8192 elements a thread keeps in registers."""
    leaves = _list_leaves(LIST_SHAPES + [(16, 16384)], cuda,
                          getattr(torch, p_dtype), getattr(torch, g_dtype))
    sc = torch.from_numpy(_scalars()).to(cuda)
    kw = dict(HP, stoch_round=p_dtype == "bfloat16", seed=STEP)
    kept, plain, launches = _kept_steps(leaves, LIST_IDS + [12], sc, kw)
    torch.cuda.synchronize()
    assert launches == 2
    _assert_leaves_equal(kept, plain)
