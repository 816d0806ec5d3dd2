"""paddle_tpu_torch GPT trainer against the reference trainer
(``paddle_tpu.models.gpt.GPTSpmdTrainer``, JAX on the CPU).

The reference runs at a tiny config (vocab 512, hidden 256, 2 heads of
128, 2 layers, T 128, batch 2, f32) on one CPU device with
``use_flash=True``, so its attention is the packed flash path
(``flash_attention_qkv_fused``, Pallas in interpret mode), and with
``fused_optimizer=False`` (its XLA AdamW; the fused Pallas AdamW has no
CPU lowering). Its parameters are made with numpy from a seed, and the
port's trainer gets the same through ``gpt_trainer_from_jax_params``.
One jitted reference step (value_and_grad of ``_forward_loss``, then
``_adamw``: the trainer's own step) runs three times in a module
fixture.

The same jitted step also takes one step, then has its ``params``
reassigned to nudged copies (numpy, through ``gpt_params_from_numpy``
on the port's side) and takes the next: the reference reassigns
``trainer.params`` every step, and the port's trainer must take the new
tree with the optimizer state kept by leaf position.

Tolerances (f32 on both sides, another summation order): step-0 loss
``atol=1e-5``; gradients ``atol=1e-6, rtol=1e-4``; the three-step loss
trajectory, and the loss after the reassignment, ``atol=1e-5``;
parameters after three steps, and after the step that follows the
reassignment, ``atol=1e-4``, a third of one Adam step (lr 3e-4): Adam
divides by sqrt(v), so a 1e-8 gradient difference on a leaf element
with a tiny v moves its update by a visible fraction of a step, never
by more.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.convert import (gpt_params_from_numpy,
                                             gpt_params_to_numpy,
                                             gpt_trainer_from_jax_params)
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTTrainer,
                                         block_shapes, flatten_params,
                                         top_shapes)

TINY = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
            max_seq_len=128)
B, T, STEPS = 2, 128, 3
SMALL = dict(TINY, num_layers=1, hidden_size=128, num_heads=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py: exact CPU numbers need
    # one intra-op thread in a process that also runs XLA
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(seed: int):
    """Reference-layout parameters (per-layer ``blocks``), weights at
    the reference's init scale, gains and biases perturbed so that every
    term of the gradient is exercised."""
    rng = np.random.RandomState(seed)
    cfg = GPTConfig(**TINY)

    def leaf(name, shape):
        if name.endswith("_g"):
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        scale = 0.02 if len(shape) == 2 else 0.01
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    params = {k: leaf(k, s) for k, s in top_shapes(cfg).items()}
    params["blocks"] = {
        f"layer_{i:03d}": {k: leaf(k, s)
                           for k, s in block_shapes(cfg).items()}
        for i in range(cfg.num_layers)}
    return params


def _nudged(np_params):
    """``np_params`` with every leaf moved by ~1% of itself (numpy, a
    fixed seed): the tree a caller assigns to ``trainer.params``."""
    rng = np.random.RandomState(2)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return (node * (1 + 0.01 * rng.standard_normal(node.shape))
                ).astype(np.float32)
    return walk(np_params)


def _batch():
    rng = np.random.RandomState(1)
    ids = rng.randint(0, TINY["vocab_size"], (B, T)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


@pytest.fixture(scope="module")
def ref():
    """Three steps of the reference trainer: per-step losses, the step-0
    gradients, and the parameters after the last step; and from step 0's
    optimizer state, one step of ``_nudged`` parameters assigned after
    it: its loss and the parameters it gives (all numpy). JAX is
    imported here: the card's machine runs this file's cuda test without
    it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from paddle_tpu.models import gpt as jgpt
    np_params = _np_params(0)
    cfg = jgpt.GPTConfig(**TINY, dtype=jnp.float32)
    mesh = jgpt.build_mesh(n_devices=1)
    with pytest.MonkeyPatch.context() as mp:
        # the numpy parameters in place of its jax.random init
        mp.setattr(jgpt.GPTSpmdTrainer, "_init_params",
                   lambda self, key: jax.tree.map(jnp.asarray, np_params))
        tr = jgpt.GPTSpmdTrainer(
            cfg, mesh, microbatches=1, use_flash=True, remat=False,
            master_dtype=jnp.float32, moment_dtype=jnp.float32,
            fused_optimizer=False, layer_unroll="full", ce_chunks=16)

    # the trainer's step (build_step with f32 masters): value_and_grad
    # of _forward_loss, then _adamw
    loss_and_grads = jax.jit(jax.value_and_grad(tr._forward_loss))
    adamw = jax.jit(tr._adamw)
    ids, labels = _batch()
    # placed as the step's outputs are, so steps 1.. reuse step 0's
    # compiled programs
    params, opt_state = jax.device_put((tr.params, tr.opt_state),
                                       NamedSharding(mesh, P()))
    losses = []
    nudged = _nudged(np_params)
    with jax.set_mesh(mesh):
        for i in range(STEPS):
            loss, grads = loss_and_grads(params, ids, labels)
            params, opt_state = adamw(params, grads, opt_state)
            losses.append(float(loss))
            if i == 0:
                grads0 = jax.tree.map(np.asarray, grads)
                opt_state0 = opt_state
        # trainer.params = nudged after step 0, then the next step
        assigned = jax.device_put(jax.tree.map(jnp.asarray, nudged),
                                  NamedSharding(mesh, P()))
        loss, grads = loss_and_grads(assigned, ids, labels)
        assigned, _ = adamw(assigned, grads, opt_state0)
    return {"np_params": np_params, "losses": losses, "grads0": grads0,
            "params": jax.tree.map(np.asarray, params),
            "reassigned": {"np_params": nudged, "loss": float(loss),
                           "params": jax.tree.map(np.asarray, assigned)}}


def _leaves(tree):
    """A dict tree's leaves in jax.tree.leaves order (sorted keys)."""
    return [a for _, a in flatten_params(tree)]


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _port(np_params):
    return gpt_trainer_from_jax_params(
        np_params, GPTConfig(**TINY, dtype="float32"), device="cpu",
        dtype="float32", moment_dtype="float32", ce_chunks=16)


def test_leaf_order_is_the_references_flatten_order(ref):
    """The AdamW leaf_id (and its SR stream) is a leaf's index in
    jax.tree.flatten order: 4 + 12 per layer leaves."""
    import jax
    paths = [".".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(ref["np_params"])[0]]
    port = _port(ref["np_params"])
    assert [p for p, _ in flatten_params(port.params)] == paths
    assert len(paths) == 4 + 12 * TINY["num_layers"]
    assert port.n_params() == sum(a.size for a in
                                  jax.tree.leaves(ref["np_params"]))


def test_step0_loss_and_every_gradient_match_reference(ref):
    port = _port(ref["np_params"])
    ids, labels = _batch()
    before = port.params["wte"].detach().clone()
    loss, grads = port.loss_and_grads(ids, labels)
    assert torch.equal(port.params["wte"], before)   # no update here
    np.testing.assert_allclose(float(loss), ref["losses"][0], atol=1e-5)
    want = _leaves(ref["grads0"])
    assert len(grads) == len(want)
    for (path, _), g, w in zip(flatten_params(port.params), grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-4,
                                   err_msg=path)


def test_three_step_trajectory_matches_reference(ref):
    port = _port(ref["np_params"])
    ids, labels = _batch()
    losses = [float(port.train_step(ids, labels)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref["losses"], atol=1e-5)
    assert losses[-1] < losses[0]
    got = _leaves(gpt_params_to_numpy(port.params))
    for g, w in zip(got, _leaves(ref["params"])):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_reassigned_params_take_the_next_step_as_the_reference(ref):
    """One step, then ``port.params = `` the reference's reassigned tree:
    the next step's loss and parameters match the reference's, with the
    AdamW state of step 0 kept by leaf position."""
    port = _port(ref["np_params"])
    ids, labels = _batch()
    port.train_step(ids, labels)
    want = ref["reassigned"]
    cfg = GPTConfig(**TINY, dtype="float32")
    port.params = gpt_params_from_numpy(want["np_params"], cfg,
                                        device="cpu", dtype="float32")
    loss = float(port.train_step(ids, labels))
    assert port.opt_state["step"] == 2
    np.testing.assert_allclose(loss, want["loss"], atol=1e-5)
    got = _leaves(gpt_params_to_numpy(port.params))
    for g, w in zip(got, _leaves(want["params"])):
        np.testing.assert_allclose(g, w, atol=1e-4)
    # a tree that is not the trainer's is refused
    bad = gpt_params_from_numpy(want["np_params"], cfg, device="cpu",
                                dtype="float32")
    bad["wpe"] = bad["wpe"][:-1]
    with pytest.raises(ValueError, match="wpe"):
        port.params = bad


def test_converter_round_trip_in_both_layouts(ref):
    np_params = ref["np_params"]
    port = _port(np_params)
    back = gpt_params_to_numpy(port.params)
    for a, b in zip(_leaves(back), _leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    stacked = gpt_params_to_numpy(port.params, layout="stacked")
    assert stacked["blocks"]["wqkv"].shape == (1, 2, 256, 768)
    again = gpt_params_to_numpy(_port(stacked).params)
    for a, b in zip(_leaves(again), _leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_converter_refuses_missed_transpose_and_wrong_names(ref):
    bad = _copy(ref["np_params"])
    bad["blocks"]["layer_000"]["win"] = bad["blocks"]["layer_000"]["win"].T
    with pytest.raises(ValueError, match="win"):
        _port(bad)
    bad = _copy(ref["np_params"])
    bad["wte_extra"] = bad.pop("wte")
    with pytest.raises(KeyError):
        _port(bad)
    bad = _copy(ref["np_params"])
    bad["blocks"]["layer_001"]["wqkv_t"] = \
        bad["blocks"]["layer_001"].pop("wqkv")
    with pytest.raises(KeyError):
        _port(bad)


@pytest.mark.parametrize("kw", [
    {"remat": True}, {"remat": "save_dots"}, {"remat": "save_qkv_ffn"},
    {"moe_experts": 4}, {"pipeline_schedule": "1f1b"}, {"microbatches": 2},
    {"remat": "save_main"}, {"remat": "save_main", "quant8": "dgrad"},
    {"remat": "save_main", "quant8": "wgrad", "int8_guard_period": 10},
    {"fused_optimizer": False}, {"layer_unroll": 1}])
def test_later_slice_options_raise(kw):
    # the int8 tiers, fuse_ln_quant, ce_int8 and the drift guard are
    # ported (test_torch_gpt_int8_tiers.py); remat policies, save_main
    # off quant8="wgrad" (and so the guard under it), MoE and pipelines
    # are later slices
    with pytest.raises(NotImplementedError, match="slice"):
        GPTTrainer(GPTConfig(**TINY, dtype="float32"), device="cpu", **kw)


def test_bf16_masters_take_stochastic_rounding_and_train():
    """The flagship recipe on the CPU (one layer): bf16 masters and
    moments, SR in the optimizer; the loss falls over three steps and
    the masters stay bf16."""
    cfg = GPTConfig(**SMALL, dtype="bfloat16")
    tr = GPTTrainer(cfg, device="cpu", master_dtype="bfloat16",
                    moment_dtype="bfloat16", ce_chunks=1, seed=0)
    ids, labels = _batch()
    losses = [float(tr.train_step(ids, labels)) for _ in range(STEPS)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.dtype == torch.bfloat16 for _, p in
               flatten_params(tr.params))


def test_lr_schedule_hook_scales_the_step():
    """``lr_schedule`` is called with the step number and multiplies the
    lr: at 0 the bf16 masters keep their bits (SR of an exact value)."""
    seen = []
    tr = GPTTrainer(GPTConfig(**SMALL, dtype="bfloat16"), device="cpu",
                    master_dtype="bfloat16", moment_dtype="bfloat16",
                    ce_chunks=1,
                    lr_schedule=lambda t: seen.append(t) or 0.0)
    before = [p.detach().clone() for p in _leaves(tr.params)]
    ids, labels = _batch()
    for _ in range(2):
        tr.train_step(ids, labels)
    assert seen == [1.0, 2.0]
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(tr.params)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_step_launches_every_kernel(cuda):
    """One bf16 step on the card: one flash forward and one flash
    backward launch per layer, one AdamW launch for every leaf."""
    from paddle_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                      flash_attention_fwd)
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_update_leaves
    cfg = GPTConfig(**TINY, dtype="bfloat16")
    tr = GPTTrainer(cfg, device=cuda, master_dtype="bfloat16",
                    moment_dtype="bfloat16", ce_chunks=1)
    ids, labels = _batch()
    counts = (flash_attention_fwd.launches, flash_attention_bwd.launches,
              fused_adamw_update_leaves.launches)
    loss = tr.train_step(ids, labels)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (flash_attention_fwd.launches - counts[0],
            flash_attention_bwd.launches - counts[1],
            fused_adamw_update_leaves.launches - counts[2]) == (L, L, 1)
    assert torch.isfinite(loss)
