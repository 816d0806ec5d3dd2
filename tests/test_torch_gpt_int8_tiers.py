"""paddle_tpu_torch GPT trainer's int8 ladder against the reference
trainer (``paddle_tpu.models.gpt.GPTSpmdTrainer``, JAX on the CPU):
``fuse_ln_quant`` (kernel rows 10 and 11 on the qkv and ffn1 sites), the
``quant8="dgrad"`` tier with ``ce_int8``, the drift guard, and the
trainer's option checks.

The reference runs at the tiny config of ``test_torch_gpt_flagship.py``
(vocab 512, hidden 256, 2 heads of 128, T 128, batch 2, f32,
``fused_optimizer=False``) with ``use_flash=False``, its CPU default:
einsum attention (the flash kernels are held by
``test_torch_flash_attention.py``), so no Pallas interpret mode here.
Two reference builds, each module-scoped, jit ``_forward_loss``'s
gradient once (the seed traced) and run three-step trajectories:

- ``fuse_ln_quant=True, fuse_bwd_colq=True, remat="save_main"`` (with
  ``quant8="wgrad"``), 2 layers, on the trainer's seeds and at seeds
  offset by a constant. Its drift guard then walks the ladder at
  threshold 1e-9.
- ``quant8="dgrad", ce_int8=True, remat=False``, 1 layer (compiling a
  layer costs ~1 s): no SR, so one trajectory.

The port gets the same numpy parameters through
``gpt_trainer_from_jax_params``. Tolerances: step-0 loss ``atol=1e-4``;
the SR wgrad leaves (wqkv, win, wout) within 1.5 times the reference's
own seed-to-seed distance, as ``test_torch_gpt_flagship.py`` holds
them. Every other gradient passes through RTN int8 dgrads (and the
int8 CE head), where a rounding boundary turns an ulp into a whole
code: the reference's own gradients move by 0.02-1.9% of their norm
when its parameters move by one ulp, the port's lie 0.001-0.74% from
the reference's. So each is held within that one-ulp distance of the
reference's, leaf by leaf (measured up to 0.35 of it), and within
1e-2 of its norm. The wgrad trajectory within twice the reference's
seed-to-seed spread plus 1e-4, the deterministic "dgrad" one within
1e-3. The guard's probe draws its Gaussian cotangent from a
``torch.Generator`` (the reference from ``jax.random``), so its values
are held in distribution: both in (1e-4, 0.2) and within a factor 1.5
of each other.

Port-only checks at a smaller config (hidden 128, 1 layer, T 64): every
``fuse_ln_quant`` mode with ``fuse_bwd_colq`` both ways, and
``fuse_gelu_quant=False``, track the port's flagship over three steps
within 0.05 (``tests/test_fuse_ln_modes.py``'s bar), and the guard stays
quiet at its default threshold over four steps.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.convert import gpt_trainer_from_jax_params
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTTrainer, block_shapes,
                                         flatten_params, top_shapes)
from paddle_tpu_torch.ops.quant_matmul import layer_seed, step_seed

TINY = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
            max_seq_len=128)
SMALL = dict(vocab_size=256, hidden_size=128, num_layers=1, num_heads=2,
             max_seq_len=64)
B, STEPS = 2, 3
FUSED = dict(quant8="wgrad", remat="save_main", fuse_ln_quant=True,
             fuse_bwd_colq=True)
DGRAD = dict(quant8="dgrad", ce_int8=True, remat=False)
WGRAD = ("wqkv", "win", "wout")
ALT = 12345                      # a second seed offset: the noise spread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # see tests/test_torch_flash_attention.py
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(seed: int, config=TINY):
    """Reference-layout parameters, as ``test_torch_gpt_trainer.py``
    makes them (gains and biases perturbed)."""
    rng = np.random.RandomState(seed)
    cfg = GPTConfig(**config)

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


def _batch(config=TINY):
    rng = np.random.RandomState(1)
    ids = rng.randint(0, config["vocab_size"],
                      (B, config["max_seq_len"])).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _port(np_params, recipe, config=TINY, **kw):
    return gpt_trainer_from_jax_params(
        np_params, GPTConfig(**config, dtype="float32"), device="cpu",
        dtype="float32", moment_dtype="float32", ce_chunks=16,
        **{**recipe, **kw})


def _reference(recipe, offsets, config):
    """A reference trainer with ``recipe``: the step-0 loss and
    gradients and a three-step loss trajectory at each seed offset, the
    step-0 gradients at parameters one ulp up, and the trainer."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from paddle_tpu.models import gpt as jgpt
    np_params = _np_params(0, config)
    cfg = jgpt.GPTConfig(**config, dtype=jnp.float32)
    mesh = jgpt.build_mesh(n_devices=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgpt.GPTSpmdTrainer, "_init_params",
                   lambda self, key: jax.tree.map(jnp.asarray, np_params))
        tr = jgpt.GPTSpmdTrainer(
            cfg, mesh, microbatches=1, use_flash=False,
            master_dtype=jnp.float32, moment_dtype=jnp.float32,
            fused_optimizer=False, layer_unroll="full", ce_chunks=16,
            **recipe)
    loss_and_grads = jax.jit(jax.value_and_grad(tr._forward_loss))
    adamw = jax.jit(tr._adamw)
    ids, labels = _batch(config)
    params, opt_state = jax.device_put((tr.params, tr.opt_state),
                                       NamedSharding(mesh, P()))
    up = jax.device_put(jax.tree.map(
        lambda a: np.nextafter(np.asarray(a), np.inf), params),
        NamedSharding(mesh, P()))       # placed as params: no recompile
    out = {"np_params": np_params, "trainer": tr, "mesh": mesh,
           "config": config}
    with jax.set_mesh(mesh):
        seed = jnp.int32(step_seed(0)) if recipe["quant8"] == "wgrad" \
            else None
        out["grads_up"] = [np.asarray(g) for g in jax.tree.leaves(
            loss_and_grads(up, ids, labels, seed)[1])]
        for offset in offsets:
            p, o, losses = params, opt_state, []
            for i in range(STEPS):
                seed = jnp.int32(step_seed(i) + offset) \
                    if recipe["quant8"] == "wgrad" else None
                loss, grads = loss_and_grads(p, ids, labels, seed)
                if i == 0:
                    out[("grads", offset)] = [np.asarray(g) for g in
                                              jax.tree.leaves(grads)]
                    out[("loss", offset)] = float(loss)
                p, o = adamw(p, grads, o)
                losses.append(float(loss))
            out[("traj", offset)] = losses
    return out


@pytest.fixture(scope="module")
def ref_fused():
    """The ``fuse_ln_quant`` build; then its guard's ladder at threshold
    1e-9 from its initial weights (two probes, one per tier)."""
    import jax
    import jax.numpy as jnp
    out = _reference(FUSED, (0, ALT), TINY)
    tr = out["trainer"]
    assert tr.fuse_ln_quant is True and tr.fuse_bwd_colq
    tr.int8_guard_threshold = 1e-9
    with jax.set_mesh(out["mesh"]):
        for _ in range(2):
            tr._run_guard(jnp.asarray(_batch()[0]))
    out["events"] = tr.guard_events()
    return out


@pytest.fixture(scope="module")
def ref_dgrad():
    return _reference(DGRAD, (0,), dict(TINY, num_layers=1))


def _check_step0(ref, recipe):
    config = ref["config"]
    port = _port(ref["np_params"], recipe, config)
    loss, grads = port.loss_and_grads(*_batch(config))
    np.testing.assert_allclose(float(loss), ref[("loss", 0)], atol=1e-4)
    want = ref[("grads", 0)]
    alts = ref.get(("grads", ALT), [None] * len(want))
    for (path, _), g, w, up, alt in zip(flatten_params(port.params), grads,
                                        want, ref["grads_up"], alts):
        dist = np.linalg.norm(g.numpy() - w)
        if alt is not None and path.rsplit(".", 1)[-1] in WGRAD:
            spread = np.linalg.norm(alt - w)
            assert 0 < dist < 1.5 * spread, (path, dist, spread)
        else:
            ulp = np.linalg.norm(up - w)
            assert dist < min(ulp, 1e-2 * np.linalg.norm(w)), \
                (path, dist, ulp)


def test_fused_ln_step0_loss_and_every_gradient_match_reference(ref_fused):
    _check_step0(ref_fused, FUSED)


def test_fused_ln_trajectory_within_the_references_seed_spread(ref_fused):
    port = _port(ref_fused["np_params"], FUSED)
    losses = [float(port.train_step(*_batch())) for _ in range(STEPS)]
    want = ref_fused[("traj", 0)]
    spread = np.abs(np.subtract(want, ref_fused[("traj", ALT)]))
    assert np.all(np.abs(np.subtract(losses, want)) <= 2 * spread + 1e-4), \
        (losses, want, spread)
    assert losses[-1] < losses[0]


def test_dgrad_ce_int8_step0_loss_and_every_gradient_match(ref_dgrad):
    _check_step0(ref_dgrad, DGRAD)


def test_dgrad_ce_int8_trajectory_matches_reference(ref_dgrad):
    config = ref_dgrad["config"]
    port = _port(ref_dgrad["np_params"], DGRAD, config)
    losses = [float(port.train_step(*_batch(config))) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref_dgrad[("traj", 0)], atol=1e-3)
    assert losses[-1] < losses[0]


def test_guard_ladder_and_probe_match_the_reference(ref_fused):
    """Threshold 1e-9: "wgrad" -> "dgrad" -> exact, one tier a step, as
    the reference's guard falls from the same weights; each probe value
    (the event's rel_err) beside the reference's."""
    port = _port(ref_fused["np_params"], FUSED, remat=False,
                 int8_guard_period=1, int8_guard_threshold=1e-9)
    assert port.int8_guard_threshold == 1e-9
    ids, labels = _batch()
    for _ in range(3):
        port.train_step(ids, labels)
    got, want = port.guard_events(), ref_fused["events"]
    assert [(e["from"], e["to"]) for e in got] == \
        [(e["from"], e["to"]) for e in want] == \
        [("wgrad", "dgrad"), ("dgrad", False)]
    assert [e["step"] for e in got] == [0, 1] and port.quant8 is False
    for mine, ref in zip(got, want):
        assert 1e-4 < mine["rel_err"] < 0.2 and 1e-4 < ref["rel_err"] < 0.2
        assert 1 / 1.5 < mine["rel_err"] / ref["rel_err"] < 1.5, (mine, ref)


def test_guard_stays_quiet_at_the_default_threshold():
    tr = _port(_np_params(3, SMALL), dict(quant8="wgrad"), SMALL,
               int8_guard_period=1)
    assert tr.int8_guard_threshold == 0.10
    ids, labels = _batch(SMALL)
    losses = [float(tr.train_step(ids, labels)) for _ in range(4)]
    assert tr.guard_events() == [] and tr.quant8 == "wgrad"
    assert tr._host_step == 4 and losses[-1] < losses[0]


@pytest.fixture(scope="module")
def flagship_small():
    """The port's flagship recipe at SMALL: three steps' losses."""
    tr = _port(_np_params(4, SMALL), dict(quant8="wgrad",
                                          remat="save_main"), SMALL)
    return [float(tr.train_step(*_batch(SMALL))) for _ in range(STEPS)]


@pytest.mark.parametrize("kw", [
    dict(fuse_ln_quant=mode, fuse_bwd_colq=colq)
    for mode in (True, "qkv", "ffn1") for colq in (True, False)]
    + [dict(fuse_gelu_quant=False), dict(fuse_gelu_quant=False, remat=False)])
def test_int8_modes_track_the_flagship(flagship_small, kw):
    tr = _port(_np_params(4, SMALL), dict(quant8="wgrad",
                                          remat="save_main"), SMALL, **kw)
    losses = [float(tr.train_step(*_batch(SMALL))) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, flagship_small, rtol=0, atol=0.05)
    assert losses[-1] < losses[0]


def test_fused_sites_keep_their_row_statistics():
    """save_main with both sites fused keeps the block input, the four
    residuals and each fused site's mean and rstd ([B, T, 1] f32), and
    recomputes no LayerNorm in the backward."""
    tr = _port(_np_params(5, SMALL), FUSED, SMALL)
    bp = tr.params["blocks"]["layer_000"]
    D = SMALL["hidden_size"]
    x = torch.from_numpy(np.random.RandomState(6).standard_normal(
        (B, SMALL["max_seq_len"], D)).astype(np.float32)).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = tr._block(x, bp, layer_seed(step_seed(0), 0))
    weights = {p.data_ptr() for p in bp.values()}
    acts = [t for t in saved if t.data_ptr() not in weights]
    stats = [t for t in acts if t.shape[-1] == 1]
    assert len(acts) == 5 + 4 and len(stats) == 4
    assert all(t.dtype == torch.float32 and t.numel() == B * SMALL[
        "max_seq_len"] for t in stats)
    y.sum().backward()
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("kw,error,match", [
    (dict(quant8="wgrad", fuse_ln_quant="FFN1"), ValueError, "fuse_ln_quant"),
    (dict(quant8="dgrad", fuse_ln_quant=True), ValueError, "all-int8"),
    (dict(quant8=True, fuse_gelu_quant=True), ValueError, "all-int8"),
    (dict(quant8=False, fuse_ln_quant="qkv"), ValueError, "all-int8")])
def test_bad_values_raise_as_the_reference(kw, error, match):
    import jax.numpy as jnp
    from paddle_tpu.models import gpt as jgpt
    cfg = SMALL
    with pytest.raises(error, match=match):
        jgpt.GPTSpmdTrainer(jgpt.GPTConfig(**cfg, dtype=jnp.float32),
                            jgpt.build_mesh(n_devices=1), **kw)
    with pytest.raises(error, match=match):
        GPTTrainer(GPTConfig(**cfg, dtype="float32"), device="cpu", **kw)


def test_port_rejects_what_it_does_not_run():
    cfg = GPTConfig(**SMALL, dtype="float32")
    with pytest.raises(ValueError, match="quant8 must be"):
        GPTTrainer(cfg, device="cpu", quant8="wgard")
    with pytest.raises(NotImplementedError, match="remat slice"):
        GPTTrainer(cfg, device="cpu", quant8="wgrad", remat="save_main",
                   int8_guard_period=1)
    with pytest.raises(NotImplementedError, match="remat slice"):
        GPTTrainer(cfg, device="cpu", quant8="dgrad", remat="save_main")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_bwd_colq", [True, False])
def test_cuda_fused_ln_step_launches_rows_10_and_11(cuda, fuse_bwd_colq):
    """One bf16 step with both sites fused: per layer 2 row-10 launches
    (qkv, ffn1 forward) and, with fuse_bwd_colq, 2 row-11 launches (their
    wgrad) in place of 2 of row 12's; 7 row and 3 column quantizes."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    fns = (qm.quantize_rows, qm.quantize_cols, qm.sr_quantize_colwise,
           qm.ln_quantize_rowwise, qm.sr_quantize_colwise_ln)
    tr = GPTTrainer(GPTConfig(**TINY, dtype="bfloat16"), device=cuda,
                    master_dtype="bfloat16", moment_dtype="bfloat16",
                    ce_chunks=1, moment8=True, **dict(
                        FUSED, fuse_bwd_colq=fuse_bwd_colq))
    before = [f.launches for f in fns]
    loss = tr.train_step(*_batch())
    torch.cuda.synchronize()
    L = TINY["num_layers"]
    fused = 2 * L * fuse_bwd_colq
    assert [f.launches - b for f, b in zip(fns, before)] == \
        [7 * L, 3 * L, 6 * L - fused, 2 * L, fused]
    assert torch.isfinite(loss)
