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
- On the card (marker ``cuda``): the kernel against the plain version
  within one bf16 step of the output's magnitude (tensor-core dots in
  another order), at decode and prefill shapes, ragged M and N, a zero
  group and f32 x; a row's bits not depending on M; and the launches of
  one forward of an int4 model.
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
    """The kernel's K split for Llama-1B's shapes: whole groups, enough
    blocks to fill the card, never depending on M."""
    assert im.int4_splits(2048, 2048, 128) == 8
    assert im.int4_splits(2048, 5504, 128) == 4
    assert im.int4_splits(5504, 2048, 64) == 9     # 43 groups: 8 x 5 + 3
    assert im.int4_splits(2048, 32000, 128) == 1
    assert im.int4_splits(256, 96, 64) == 2


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
    x, p, s = _operands(300, 5504, 2048, 64, cuda)
    full = im.int4_matmul(x, p, s, 64)
    for m in (1, 16, 17, 64):
        assert torch.equal(im.int4_matmul(x[:m].contiguous(), p, s, 64),
                           full[:m])


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
