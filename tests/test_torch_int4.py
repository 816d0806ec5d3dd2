"""paddle_tpu_torch weight-only int4 matmul (kernel row 7) against the
reference (``paddle_tpu.ops.int4_matmul``, JAX on the CPU).

Inputs come from numpy seeds and go to both packages.

- The torch quantizers equal the reference's numpy ``quantize_int4_rows``
  and ``pack_rows_int4`` bit for bit, on f32 and bf16 weights with an
  all-zero group (scale 1, codes 0).
- ``int4_matmul_plain`` against the reference's Pallas kernel in
  interpret mode (f32 compute, as the reference's ``cdtype`` is on the
  CPU) at M in {1, 5, 16}, f32 and bf16 x, and at the group-fallback
  shape: the two add the same f32 products per group in the same group
  order, but each group's dot in another order, so f32 outputs agree
  to 2e-6 of the output's largest magnitude and bf16 outputs within one
  bf16 step of it.
- The reference's ``ValueError``s, with its messages.
- The decode kernel's plan (column tile, warps a block, K splits)
  follows the weight's shape only.
- On the card (marker ``cuda``): both kernels (decode M <= 16, prefill
  above) against the plain version within one bf16 step of the output's
  magnitude (tensor-core dots in another order), at decode and prefill
  shapes, M from 1 to 512, group 64 and 128, an N that is not a multiple
  of a column tile, a zero group and f32 x; the same bits on two runs; a
  row's bits not depending on M within a regime; one kernel event per
  call under torch.profiler; and the launches of one forward of an int4
  model.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import int4_matmul as im


def _weight(K, N, seed, zero_group=None, group=64):
    rng = np.random.RandomState(seed)
    w = (rng.standard_normal((K, N)) * 10.0 ** rng.uniform(-2, 0, N)
         ).astype(np.float32)
    if zero_group is not None:
        g, n = zero_group
        w[g * group:(g + 1) * group, n] = 0
    return w


def bf16_step(y) -> float:
    """The spacing of bf16 values at the largest magnitude in ``y``."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(y).max()))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_match_reference_bit_for_bit(dtype):
    import ml_dtypes
    from paddle_tpu.ops.int4_matmul import pack_rows_int4, quantize_int4_rows
    w = _weight(256, 48, 0, zero_group=(1, 5))
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
    q, s = quantize_int4_rows(w, 64)
    tw = torch.from_numpy(w.astype(np.float32)).to(getattr(torch, dtype))
    tq, ts = im.quantize_int4_rows(tw, 64)
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_array_equal(ts.numpy(), s)
    assert ts[1, 5].item() == 1.0 and not tq[64:128, 5].any()
    packed = im.pack_rows_int4(tq)
    np.testing.assert_array_equal(packed.numpy(), pack_rows_int4(q))
    hi, lo = im.unpack_rows_int4(packed)
    np.testing.assert_array_equal(torch.cat([hi, lo]).numpy(), q)


# (M, K, N, group); the last: K/2 = 96, group 64 -> gcd(96, 64) = 32, the
# fallback Int4Linear takes
PLAIN_CASES = [(1, 256, 96, 64), (5, 256, 96, 64), (16, 256, 96, 64),
               (3, 192, 48, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,group", PLAIN_CASES)
def test_plain_matches_reference_kernel(M, K, N, group, dtype):
    import jax.numpy as jnp
    from paddle_tpu.ops.int4_matmul import (int4_matmul, pack_rows_int4,
                                            quantize_int4_rows)
    w = _weight(K, N, M, zero_group=(0, 3), group=group)
    q, s = quantize_int4_rows(w, group)
    p = pack_rows_int4(q)
    x = np.random.RandomState(100 + M).standard_normal((M, K)).astype(
        np.float32)
    want = np.asarray(int4_matmul(jnp.asarray(x).astype(dtype),
                                  jnp.asarray(p), jnp.asarray(s),
                                  group=group).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = im.int4_matmul(tx, torch.from_numpy(p), torch.from_numpy(s), group)
    assert got.dtype == tx.dtype and got.shape == (M, N)
    tol = 2e-6 * np.abs(want).max() if dtype == "float32" \
        else bf16_step(want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_reference_errors():
    from paddle_tpu.ops.int4_matmul import pack_rows_int4, quantize_int4_rows
    w = _weight(384, 32, 1)
    q, s = quantize_int4_rows(w, 128)             # 128 | 384, not 192
    p, s = torch.from_numpy(pack_rows_int4(q)), torch.from_numpy(s)
    x = torch.ones(2, 384)
    with pytest.raises(ValueError, match="K//2 = 192"):
        im.int4_matmul(x, p, s, group=128)
    with pytest.raises(ValueError, match="packed rows 191 != K//2 = 192"):
        im.int4_matmul(x, p[:-1], s, group=64)
    with pytest.raises(ValueError, match="scales shape"):
        im.int4_matmul(x, p, s, group=64)
    with pytest.raises(ValueError, match="% group"):
        im.quantize_int4_rows(torch.zeros(100, 8), 128)


def test_splits_depend_on_the_weight_only():
    """The decode kernel's plan for Llama-1B's shapes: whole groups, the
    warps of a block dividing the splits, at most 8 blocks (one cluster)
    a tile; all from the weight's shape, never from M."""
    assert im.int4_plan(2048, 2048, 128) == (32, 4, 8)
    assert im.int4_plan(2048, 5504, 128) == (64, 8, 8)
    assert im.int4_plan(5504, 2048, 64) == (64, 4, 24)   # 43 groups
    assert im.int4_plan(2048, 32000, 128) == (64, 2, 2)
    assert im.int4_plan(256, 96, 64) == (32, 2, 2)
    for K, N, group in [(2048, 2048, 128), (5504, 2048, 64), (2048, 2064, 64),
                        (2048, 32000, 128), (256, 80, 16), (192, 48, 32),
                        (11008, 4096, 128), (8192, 28672, 128),
                        (16384, 64, 128)]:
        bn, warps, splits = im.int4_plan(K, N, group)
        assert bn in (32, 64) and 1 <= warps <= 8 and splits % warps == 0
        assert splits <= K // 2 // group and splits // warps <= 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


def _operands(M, K, N, group, dev, dtype=torch.bfloat16, seed=0):
    w = _weight(K, N, seed, zero_group=(1, 7), group=group)
    q, s = im.quantize_int4_rows(torch.from_numpy(w), group)
    x = torch.from_numpy(np.random.RandomState(seed + 1).standard_normal(
        (M, K)).astype(np.float32))
    return (x.to(dev, dtype), im.pack_rows_int4(q).to(dev), s.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,group", [
    (1, 2048, 2048, 128), (16, 2048, 5504, 128), (8, 5504, 2048, 64),
    (300, 2048, 2048, 128), (512, 5504, 2048, 64), (3, 256, 80, 32),
    (70, 256, 80, 16)])
def test_cuda_kernel_matches_plain(cuda, M, K, N, group):
    x, p, s = _operands(M, K, N, group, cuda)
    got = im.int4_matmul(x, p, s, group)
    want = im.int4_matmul_plain(x, p, s, group)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    w = want.float().cpu().numpy()
    np.testing.assert_allclose(got.float().cpu().numpy(), w, rtol=0,
                               atol=bf16_step(w))
    # f32 x: the kernel rounds x to bf16, and answers in f32
    got32 = im.int4_matmul(x.float(), p, s, group)
    np.testing.assert_allclose(got32.cpu().numpy(), want.float().cpu().numpy(),
                               rtol=0, atol=bf16_step(w))


@pytest.mark.cuda
def test_cuda_rows_do_not_depend_on_m(cuda):
    """Within a regime a row's bits do not depend on M: decode (M <= 16)
    rows of 1, 2 and 8 are those of 16, prefill rows of 17, 64 and 300
    those of 512. Across the regimes (16 / 17) they may differ."""
    x, p, s = _operands(512, 5504, 2048, 64, cuda)
    for ref, ms in ((16, (1, 2, 8)), (512, (17, 64, 300))):
        full = im.int4_matmul(x[:ref].contiguous(), p, s, 64)
        for m in ms:
            assert torch.equal(im.int4_matmul(x[:m].contiguous(), p, s, 64),
                               full[:m])


REGIME_MS = (1, 2, 8, 16, 17, 64, 300, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_both_regimes(cuda, group, dtype):
    """Both kernels against the plain version within one bf16 step at
    N = 2064 (not a multiple of a column tile), M from 1 to 512, and the
    same bits on a second run."""
    x, p, s = _operands(max(REGIME_MS), 2048, 2064, group, cuda,
                        dtype=getattr(torch, dtype))
    for m in REGIME_MS:
        xm = x[:m].contiguous()
        got = im.int4_matmul(xm, p, s, group)
        want = im.int4_matmul_plain(xm, p, s, group)
        w = want.float().cpu().numpy()
        assert got.dtype == xm.dtype and got.shape == (m, 2064)
        np.testing.assert_allclose(got.float().cpu().numpy(), w, rtol=0,
                                   atol=bf16_step(w))
        assert torch.equal(got, im.int4_matmul(xm, p, s, group))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 17, 300])
def test_cuda_all_zero_group(cuda, M):
    """A group of rows zero in every column: scale 1, codes 0, and the
    kernel adds nothing for it."""
    w = _weight(1024, 2048, 3)
    w[128:256] = 0
    q, s = im.quantize_int4_rows(torch.from_numpy(w), 128)
    assert (s[1] == 1.0).all() and not q[128:256].any()
    x = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (M, 1024)).astype(np.float32)).to(cuda, torch.bfloat16)
    p, s = im.pack_rows_int4(q).to(cuda), s.to(cuda)
    got = im.int4_matmul(x, p, s, 128)
    want = im.int4_matmul_plain(x, p, s, 128).float().cpu().numpy()
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=0,
                               atol=bf16_step(want))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 17, 512])
def test_cuda_one_kernel_event_per_call(cuda, M):
    """int4_matmul is one launch: ten calls show ten events of one int4
    kernel under torch.profiler, and nothing else on the card."""
    from torch.profiler import ProfilerActivity, profile
    x, p, s = _operands(M, 2048, 2048, 128, cuda)
    im.int4_matmul(x, p, s, 128)               # build, workspace
    torch.cuda.synchronize()
    for _ in range(5):                         # a trace may drop events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                im.int4_matmul(x, p, s, 128)
            torch.cuda.synchronize()
        ev = {e.key: e.count for e in prof.key_averages()
              if e.self_device_time_total > 0}
        if sum(ev.values()) >= 10:
            break
    assert len(ev) == 1 and "int4_mm_" in next(iter(ev))
    assert next(iter(ev.values())) == 10


@pytest.mark.cuda
def test_cuda_int4_llama_forward_launches(cuda):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               llama_tiny_config)
    from paddle_tpu_torch.quantization import weight_only_int4
    cfg = llama_tiny_config(hidden_size=128, intermediate_size=256,
                            vocab_size=256)          # 4 heads of 32
    model = weight_only_int4(LlamaForCausalLM(cfg, device=cuda,
                                              dtype="bfloat16"),
                             group=32, min_features=64)
    ids = torch.randint(0, 256, (2, 9), device=cuda)
    im.int4_matmul.launches = 0
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    assert torch.isfinite(logits.float()).all()
    assert im.int4_matmul.launches == cfg.num_hidden_layers * 7 + 1
