"""paddle_tpu_torch fused AdamW against the reference Pallas kernel
(``paddle_tpu.ops.fused_adamw.fused_adamw_update``, interpret mode on
the CPU), and its stochastic rounding against the laws that define it.

Inputs are made with numpy from a seed and handed to both. The
reference's stochastic rounding draws from ``pltpu.prng_seed``, which
has no CPU lowering, so parity runs with ``stoch_round=False``, at f32
and at bf16 moments, with the 1-2 ulp bar of
``tests/test_fused_adamw.py`` (interpret mode may associate f32 ops
differently): f32 ``rtol=1e-6, atol=1e-7``; bf16 outputs within one
bf16 ulp. The SR stream (Philox4x32-10) is held to its published
known-answer vector, and SR itself to its laws: each output is one of
the two bf16 neighbours of the f32 update, the mean is unbiased, the
streams of different (step, leaf) pairs differ, and inf/nan are kept.
The list entry ``fused_adamw_update_leaves`` is held to the per-leaf
plain version bit for bit, SR on, on mixed shapes and in any list
order, and so is an ``AdamWLeaves`` table kept over steps with new
gradients each step; a kept table no longer holds a leaf whose storage
was swapped. On the card (tests marked ``cuda``) the kernel is held to the
plain version bit for bit, SR included: one leaf, every dtype
combination of a list with odd lengths and a misaligned view, and 300
leaves in one launch.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.fused_adamw import (AdamWLeaves,
                                              fused_adamw_update,
                                              fused_adamw_update_leaves,
                                              fused_adamw_update_plain,
                                              philox_words,
                                              stochastic_round_bf16)

HP = dict(lr=3e-4, wd=0.1, b1=0.9, b2=0.95, eps=1e-8)
STEP = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(shape, seed):
    rng = np.random.RandomState(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * np.abs(rng.standard_normal(shape))).astype(np.float32)
    return p, g, m, v


def _scalars(scale=0.5, step=STEP, lr_mult=1.0):
    b1, b2 = np.float32(HP["b1"]), np.float32(HP["b2"])
    t, one = np.float32(step), np.float32(1)
    return np.array([scale, one / (one - b1 ** t), one / (one - b2 ** t),
                     lr_mult], np.float32)


def _port(p, g, m, v, sc, dtype, **kw):
    p, g, m, v = (torch.from_numpy(a.copy()) for a in (p, g, m, v))
    m, v = m.to(dtype), v.to(dtype)
    before = fused_adamw_update_leaves.launches
    out = fused_adamw_update(p, g, m, v, torch.from_numpy(sc), **HP, **kw)
    assert fused_adamw_update_leaves.launches == before  # CPU: plain
    return [t.float().numpy() for t in out]


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_matches_reference_kernel_without_sr(moment_dtype):
    # imported here: the card's machine runs this file's cuda test
    # without JAX
    import jax.numpy as jnp
    from paddle_tpu.ops import fused_adamw as ref_adamw
    p, g, m, v = _state((64, 384), seed=0)
    sc = _scalars()
    jm = jnp.dtype(moment_dtype)
    ref = ref_adamw.fused_adamw_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m).astype(jm),
        jnp.asarray(v).astype(jm), sc[0], sc[1], sc[2], STEP, **HP,
        stoch_round=False, interpret=True, lr_scale=sc[3])
    dt = getattr(torch, moment_dtype)
    got = _port(p, g, m, v, sc, dt)
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=1e-6,
                               atol=1e-7)
    for a, b in zip(got[1:], ref[1:]):
        b = np.asarray(b.astype(jnp.float32))
        if moment_dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        else:       # one bf16 ulp (8 mantissa bits) of the moment
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-30)


def test_updates_in_place_and_applies_lr_multiplier():
    p, g, m, v = _state((16, 8), seed=1)
    tp, tg, tm, tv = (torch.from_numpy(a.copy()) for a in (p, g, m, v))
    out = fused_adamw_update(tp, tg, tm, tv,
                             torch.from_numpy(_scalars(lr_mult=0.0)), **HP)
    assert out[0] is tp and out[1] is tm and out[2] is tv
    np.testing.assert_array_equal(tp.numpy(), p)    # lr 0: p unchanged
    assert not np.array_equal(tm.numpy(), m)


def test_philox_known_answer():
    """Random123's known-answer vector for philox4x32-10: counter 0,
    key 0."""
    words = philox_words(4, 0, "cpu").tolist()
    assert words == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def _sr_update(seed=STEP, leaf_id=3, shape=(256, 256)):
    p, g, m, v = _state(shape, seed=2)
    tp = torch.from_numpy(p).bfloat16()
    args = [torch.from_numpy(a.copy()) for a in (g, m, v)]
    sc = torch.from_numpy(_scalars())
    exact = fused_adamw_update_plain(tp.float(), *[a.clone() for a in args],
                                     sc, **HP)[0]
    out = fused_adamw_update(tp.clone(), *args, sc, **HP, stoch_round=True,
                             leaf_id=leaf_id, seed=seed)[0]
    return exact, out


def test_sr_rounds_to_a_neighbour_and_streams_differ():
    exact, out = _sr_update()
    assert out.dtype == torch.bfloat16
    down = stochastic_round_bf16(exact, torch.zeros(exact.numel(),
                                                    dtype=torch.int64))
    up = stochastic_round_bf16(exact, torch.full((exact.numel(),), 0xFFFF,
                                                 dtype=torch.int64))
    assert torch.all((out == down) | (out == up))
    # truncation and the next bf16 value away from zero bracket it
    assert torch.all(down.float().abs() <= exact.abs())
    assert torch.all(exact.abs() <= up.float().abs())
    frac_up = (out != down).float().mean().item()
    assert 0.3 < frac_up < 0.7
    # another step or another leaf draws another stream: ~2f(1-f) of
    # the outputs change, f being an element's fraction of an ulp
    for other in (_sr_update(seed=STEP + 1)[1],
                  _sr_update(leaf_id=4)[1]):
        assert (other != out).float().mean().item() > 0.05
    keys = [(STEP + leaf * 1000003) for leaf in (3, 4)] + [STEP + 1 + 3000009]
    words = [philox_words(4096, k, "cpu") for k in keys]
    for a, b in ((0, 1), (0, 2), (1, 2)):
        assert (words[a] == words[b]).float().mean().item() < 0.01


def test_sr_is_unbiased():
    """The mean of many SR draws of one value is the value: 4096 draws
    at each of 64 values, within 4 standard errors of a bf16 ulp."""
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(64)
                         .astype(np.float32))
    reps = x.repeat(4096)
    words = philox_words(reps.numel(), 12345, "cpu")
    mean = stochastic_round_bf16(reps, words).float().view(4096, 64).mean(0)
    ulp = (stochastic_round_bf16(x, torch.full((64,), 0xFFFF,
                                               dtype=torch.int64)).float()
           - stochastic_round_bf16(x, torch.zeros(64, dtype=torch.int64))
           .float()).abs()
    assert torch.all((mean - x).abs() <= 4 * ulp * 0.5 / 64 + 1e-12)


def test_sr_keeps_inf_and_nan():
    x = torch.tensor([float("inf"), float("-inf"), float("nan"), 1.0])
    out = stochastic_round_bf16(x, torch.full((4,), 0xFFFF,
                                              dtype=torch.int64))
    assert out[0] == float("inf") and out[1] == float("-inf")
    assert torch.isnan(out[2])
    assert out[3].item() == 1.0     # an exact bf16 value stays exact


# mixed shapes (an odd length, a 1-element leaf) and leaf ids out of order
LEAF_SHAPES = [(64, 48), (257,), (3, 5, 7), (1,), (1000,)]
LEAF_IDS = [11, 3, 290, 0, 57]


def _leaves(device, p_dtype=torch.bfloat16, g_dtype=torch.bfloat16,
            mv_dtype=torch.bfloat16, shapes=LEAF_SHAPES, seed=5):
    out = []
    for i, shape in enumerate(shapes):
        p, g, m, v = (torch.from_numpy(a) for a in _state(shape, seed + i))
        out.append((p.to(device, p_dtype), g.to(device, g_dtype),
                    m.to(device, mv_dtype), v.to(device, mv_dtype)))
    return out


def _per_leaf_plain(leaves, ids, sc, kw):
    return [fused_adamw_update_plain(p.clone(), g, m.clone(), v.clone(),
                                     sc, leaf_id=i, **kw)
            for (p, g, m, v), i in zip(leaves, ids)]


def _list_update(leaves, ids, sc, kw):
    """``fused_adamw_update_leaves`` on copies of ``leaves``; returns
    each leaf's (p, m, v)."""
    ps, gs, ms, vs = (list(t) for t in zip(*leaves))
    ps, ms, vs = ([t.clone() for t in ts] for ts in (ps, ms, vs))
    fused_adamw_update_leaves(ps, gs, ms, vs, sc, ids, **kw)
    return list(zip(ps, ms, vs))


def test_leaves_entry_equals_per_leaf_plain_in_any_order():
    leaves = _leaves("cpu")
    sc = torch.from_numpy(_scalars())
    kw = dict(HP, stoch_round=True, seed=STEP)
    want = _per_leaf_plain(leaves, LEAF_IDS, sc, kw)
    before = fused_adamw_update_leaves.launches
    got = _list_update(leaves, LEAF_IDS, sc, kw)
    order = [3, 0, 4, 2, 1]         # the keys follow leaf_id, not position
    shuffled = _list_update([leaves[k] for k in order],
                            [LEAF_IDS[k] for k in order], sc, kw)
    assert fused_adamw_update_leaves.launches == before   # CPU: plain
    for k, (a, b) in enumerate(zip(got, want)):
        for x, y, z in zip(a, b, shuffled[order.index(k)]):
            assert torch.equal(x, y) and torch.equal(x, z)
    # another leaf_id draws another stream
    other = _list_update(leaves[:1], [12], sc, kw)[0][0]
    assert not torch.equal(other, got[0][0])
    with pytest.raises(ValueError, match="one length"):
        fused_adamw_update_leaves([leaves[0][0]], [], [], [], sc, [0], **kw)


def _kept_table_steps(leaves, ids, sc, kw, steps=2):
    """An ``AdamWLeaves`` kept over ``steps`` steps (fresh gradients and
    seed each step) against the per-leaf plain version on copies; returns
    (kept, plain) leaves' (p, m, v) and the launches the table made."""
    ps, gs, ms, vs = (list(t) for t in zip(*leaves))
    kept = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    plain = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    table = AdamWLeaves(*kept, ids)
    assert table.holds(*kept) and not table.holds(*plain)
    before = fused_adamw_update_leaves.launches
    for step in range(steps):
        grads = [g * (1 + step) for g in gs]
        args = dict(kw, seed=kw["seed"] + step)
        table.update(grads, sc, **args)
        for p, m, v, g, i in zip(*plain, grads, ids):
            fused_adamw_update_plain(p, g, m, v, sc, leaf_id=i, **args)
    return (list(zip(*kept)), list(zip(*plain)),
            fused_adamw_update_leaves.launches - before)


def test_kept_table_equals_per_leaf_plain_over_steps():
    sc = torch.from_numpy(_scalars())
    kw = dict(HP, stoch_round=True, seed=STEP)
    kept, plain, launches = _kept_table_steps(_leaves("cpu"), LEAF_IDS, sc,
                                              kw)
    assert launches == 0                                  # CPU: plain
    for a, b in zip(kept, plain):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    p, _, m, v = _leaves("cpu")[0]
    table = AdamWLeaves([p], [m], [v], [0])
    with pytest.raises(ValueError, match="1 leaves; got 2 gradients"):
        table.update([torch.zeros(1)] * 2, sc, **kw)
    with pytest.raises(ValueError, match="one length"):
        AdamWLeaves([torch.zeros(1)], [], [], [0])


def test_holds_sees_a_swapped_storage():
    """A kept table holds the leaves' addresses: after ``p.data =
    p.data.clone()`` it no longer holds that leaf (it would write at the
    old address), so the trainer lays it out again."""
    p, _, m, v = _leaves("cpu")[0]
    table = AdamWLeaves([p], [m], [v], [0])
    assert table.holds([p], [m], [v])
    p.data = p.data.clone()
    assert not table.holds([p], [m], [v])
    assert AdamWLeaves([p], [m], [v], [0]).holds([p], [m], [v])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype,mv_dtype,sr", [
    ("bfloat16", "bfloat16", True), ("bfloat16", "float32", True),
    ("float32", "float32", False), ("float32", "bfloat16", False)])
def test_cuda_kernel_matches_plain_bit_for_bit(cuda, p_dtype, mv_dtype, sr):
    p, g, m, v = (torch.from_numpy(a).to(cuda)
                  for a in _state((1000, 37), seed=4))
    p, g = p.to(getattr(torch, p_dtype)), g.to(getattr(torch, p_dtype))
    m, v = m.to(getattr(torch, mv_dtype)), v.to(getattr(torch, mv_dtype))
    sc = torch.from_numpy(_scalars()).to(cuda)
    kw = dict(HP, stoch_round=sr, leaf_id=5, seed=STEP)
    ref = fused_adamw_update_plain(p.clone(), g, m.clone(), v.clone(), sc,
                                   **kw)
    before = fused_adamw_update_leaves.launches
    got = fused_adamw_update(p, g, m, v, sc, **kw)
    torch.cuda.synchronize()
    assert fused_adamw_update_leaves.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _assert_leaves_equal(got, want):
    for k, (a, b) in enumerate(zip(got, want)):
        for name, x, y in zip("pmv", a, b):
            assert torch.equal(x, y), f"leaf {k}: {name} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("g_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mv_dtype", ["bfloat16", "float32"])
def test_cuda_leaves_kernel_matches_plain_bit_for_bit(cuda, p_dtype,
                                                       g_dtype, mv_dtype):
    """Every dtype combination: odd lengths, a 1-element leaf and a view
    whose base is not 16-byte aligned (a flat leaf less its first
    element) in one launch, SR on where p is bf16."""
    dts = [getattr(torch, d) for d in (p_dtype, g_dtype, mv_dtype)]
    leaves = _leaves(cuda, *dts, shapes=LEAF_SHAPES + [(4099,)])
    leaves[-1] = tuple(t[1:] for t in leaves[-1])      # misaligned view
    assert all(t.data_ptr() % 16 for t in leaves[-1])
    ids = LEAF_IDS + [7]
    sc = torch.from_numpy(_scalars()).to(cuda)
    kw = dict(HP, stoch_round=p_dtype == "bfloat16", seed=STEP)
    want = _per_leaf_plain(leaves, ids, sc, kw)
    before = fused_adamw_update_leaves.launches
    got = _list_update(leaves, ids, sc, kw)
    torch.cuda.synchronize()
    assert fused_adamw_update_leaves.launches == before + 1
    _assert_leaves_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_leaves", [1, 300])
def test_cuda_leaves_kernel_many_leaves_one_launch(cuda, n_leaves):
    """1 and 300 bf16 leaves of random lengths (1 to 20000; one of
    70000, several chunks) in one launch; a second dtype group in the
    list is a second launch."""
    rng = np.random.RandomState(n_leaves)
    shapes = [(int(n),) for n in rng.randint(1, 20000, n_leaves)]
    shapes[n_leaves // 2] = (70000,)
    leaves = _leaves(cuda, shapes=shapes, seed=9)
    ids = [int(i) for i in rng.permutation(1000)[:n_leaves]]
    sc = torch.from_numpy(_scalars()).to(cuda)
    kw = dict(HP, stoch_round=True, seed=STEP)
    want = _per_leaf_plain(leaves, ids, sc, kw)
    before = fused_adamw_update_leaves.launches
    got = _list_update(leaves, ids, sc, kw)
    torch.cuda.synchronize()
    assert fused_adamw_update_leaves.launches == before + 1
    _assert_leaves_equal(got, want)
    mixed = leaves[:1] + _leaves(cuda, mv_dtype=torch.float32,
                                 shapes=[(333,)], seed=10)
    before = fused_adamw_update_leaves.launches
    _assert_leaves_equal(_list_update(mixed, [1, 2], sc, kw),
                         _per_leaf_plain(mixed, [1, 2], sc, kw))
    assert fused_adamw_update_leaves.launches == before + 2


@pytest.mark.cuda
def test_cuda_kept_table_matches_plain_over_steps(cuda):
    """The trainer's way: an ``AdamWLeaves`` kept over three steps with
    new gradient tensors each step, two dtype groups (two launches a
    step) and a misaligned view, bit for bit against the plain version."""
    leaves = _leaves(cuda, shapes=LEAF_SHAPES + [(4099,)])
    leaves[-1] = tuple(t[1:] for t in leaves[-1])      # misaligned view
    leaves += _leaves(cuda, mv_dtype=torch.float32, shapes=[(333,)], seed=10)
    sc = torch.from_numpy(_scalars()).to(cuda)
    kw = dict(HP, stoch_round=True, seed=STEP)
    kept, plain, launches = _kept_table_steps(leaves, LEAF_IDS + [7, 8], sc,
                                              kw, steps=3)
    torch.cuda.synchronize()
    assert launches == 2 * 3
    _assert_leaves_equal(kept, plain)
