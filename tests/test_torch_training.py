"""The port's training pieces against the JAX package's, on the same
random inputs from a numpy seed: losses, metric statistics, one and two
optimizer steps, per-cell clipping, the monitor over a scripted loss
sequence, and the Transformer's train-mode gradients at dropout 0.

Tolerances: losses and metrics rtol 1e-6 (f32, the same formulas);
optimizer steps rtol 1e-5, atol 1e-7 (torch.optim folds the bias
corrections in another order); monitor states exactly; Transformer
gradients atol 1e-4 (f32 through 2+2 post-LN layers at E 32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sign_language_nlp_tpu.models.transformer import (
    Transformer as JaxTransformer)
from sign_language_nlp_tpu.ops import losses as jax_losses
from sign_language_nlp_tpu.ops import metrics as jax_metrics
from sign_language_nlp_tpu.training import optimizers as jax_opt
from sign_language_nlp_tpu.training import schedule as jax_sched
from sign_language_nlp_torch.models.convert import params_from_jax
from sign_language_nlp_torch.models.transformer import Transformer
from sign_language_nlp_torch.ops import losses, metrics
from sign_language_nlp_torch.ops.dropout import dropout
from sign_language_nlp_torch.training import optimizers, schedule

B, V, PAD = 12, 7, 1


def _logits(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    log_probs = np.array(jax.nn.log_softmax(logits, -1))
    y = rng.integers(0, V, size=B).astype(np.int32)
    y[:3] = PAD
    w = (rng.random(B) > 0.25).astype(np.float32)
    return log_probs, y, w


@pytest.mark.parametrize("name", ["torch.nn.CrossEntropyLoss", "nll"])
@pytest.mark.parametrize("ignore,weighted", [(PAD, True), (PAD, False),
                                             (-100, True)])
def test_losses_match_jax(name, ignore, weighted):
    log_probs, y, w = _logits()
    sw = w if weighted else None
    want = jax_losses.resolve_criterion(name)(
        log_probs, y, ignore_index=ignore, sample_weight=sw)
    got = losses.resolve_criterion(name)(
        torch.from_numpy(log_probs), torch.from_numpy(y), ignore_index=ignore,
        sample_weight=None if sw is None else torch.from_numpy(sw))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_unknown_criterion_raises():
    with pytest.raises(ValueError, match="criterion"):
        losses.resolve_criterion("torch.nn.MSELoss")


def test_metric_stats_match_jax():
    names = ("accuracy", "precision_weighted", "recall_weighted",
             "f1_weighted", "neg_log_loss", "loss")
    want = jax_metrics.init_metric_stats(V)
    got = metrics.init_metric_stats(V)
    for seed in range(3):
        log_probs, y, w = _logits(seed)
        loss_sum = np.float32(0.5 * (seed + 1))
        want = jax_metrics.update_metric_stats(want, y, log_probs, w,
                                               loss_sum=loss_sum)
        got = metrics.update_metric_stats(
            got, torch.from_numpy(y), torch.from_numpy(log_probs),
            torch.from_numpy(w), loss_sum=float(loss_sum))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, err_msg=key)
    want_f = jax_metrics.finalize_metric_stats(want, names)
    got_f = metrics.finalize_metric_stats(got, names)
    for n in names:
        np.testing.assert_allclose(got_f[n], float(want_f[n]), rtol=1e-6,
                                   err_msg=n)
    with pytest.raises(ValueError, match="metric"):
        metrics.finalize_metric_stats(got, ("roc_auc",))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("name,args", [
    ("torch.optim.SGD", {}),
    ("torch.optim.SGD", {"momentum": 0.9}),
    ("torch.optim.SGD", {"momentum": 0.9, "nesterov": True,
                         "weight_decay": 0.01}),
    ("torch.optim.Adam", {}),
    ("torch.optim.Adam", {"weight_decay": 0.1, "betas": (0.8, 0.99)}),
    ("torch.optim.AdamW", {}),
    ("torch.optim.AdamW", {"weight_decay": 0.05, "eps": 1e-6}),
])
def test_optimizer_steps_match_jax(name, args):
    lr = 0.05
    params = _tree(0)
    update, init = jax_opt.resolve_optimizer(name, args)
    want, state = params, init(params)
    tensors = {k: torch.from_numpy(v.copy()).requires_grad_()
               for k, v in params.items()}
    opt = optimizers.make_optimizer(name, args, list(tensors.values()), lr)
    for step in range(2):
        grads = _tree(10 + step)
        want, state = update(want, grads, state, jnp.float32(lr))
        for k, t in tensors.items():
            t.grad = torch.from_numpy(grads[k])
        opt.step()
    for k, t in tensors.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_set_lr_and_unknown_optimizer():
    p = torch.zeros(2, requires_grad=True)
    opt = optimizers.make_optimizer("SGD", {}, [p], 0.1)
    optimizers.set_lr(opt, 0.0)
    p.grad = torch.ones(2)
    opt.step()
    assert torch.equal(p.detach(), torch.zeros(2))  # a stopped cell's lr 0
    with pytest.raises(ValueError, match="optimizer"):
        optimizers.make_optimizer("torch.optim.LBFGS", {}, [p], 0.1)


def test_clipping_is_per_cell():
    """Each cell is clipped by its own global norm: a cell with small
    gradients is left alone beside one that is scaled down."""
    small = {k: v * 1e-3 for k, v in _tree(1).items()}
    big = {k: v * 10 for k, v in _tree(2).items()}
    for cell in (small, big):
        want = jax_opt.clip_by_global_norm(cell, 0.5)
        grads = [torch.from_numpy(cell[k].copy()) for k in ("a", "b")]
        norm = optimizers.clip_by_global_norm(grads, 0.5)
        want_norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                for v in cell.values()))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        for k, g in zip(("a", "b"), grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                       rtol=1e-6)
            if cell is small:
                np.testing.assert_array_equal(g.numpy(), cell[k])


def test_monitor_matches_jax_over_a_scripted_sequence():
    """Three cells over 14 epochs: one improves steadily, one plateaus
    (lr reductions, then the stop), one gets worse from the start (stop
    at patience). Every field equal to the JAX state at every epoch."""
    plateau = dict(factor=0.2, patience=2, threshold=1e-4,
                   threshold_mode="rel", min_lr=1e-4, enabled=True)
    early = dict(patience=5, threshold=1e-4, threshold_mode="rel",
                 enabled=True)
    losses_by_epoch = np.array(
        [[1.0 - 0.05 * e, 0.8 if e < 3 else 0.79999, 0.5 + 0.1 * e]
         for e in range(14)], np.float32)
    lr0 = np.array([0.1, 0.01, 0.5], np.float32)
    want = jax_sched.init_monitor_state(jnp.asarray(lr0))
    got = schedule.init_monitor_state(lr0)
    jp, je = jax_sched.PlateauConfig(**plateau), jax_sched.EarlyStopConfig(
        **early)
    pp, pe = schedule.PlateauConfig(**plateau), schedule.EarlyStopConfig(
        **early)
    seen_reduce = seen_stop = False
    for loss in losses_by_epoch:
        want, want_imp = jax_sched.update_monitor_state(
            want, jnp.asarray(loss), jp, je)
        got, got_imp = schedule.update_monitor_state(got, loss, pp, pe)
        np.testing.assert_array_equal(got_imp, np.asarray(want_imp))
        for field, a, b in zip(got._fields, got, want):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)
            assert a.dtype == np.asarray(b).dtype, field
        seen_reduce |= bool((got.lr < lr0).any())
        seen_stop |= bool(got.stopped.any())
    assert seen_reduce and seen_stop
    assert got.stopped.tolist() == [False, True, True]


def test_dropout_semantics():
    x = torch.ones(200, 300)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.25, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert not bool(dropout(x, 1.0, gen).any())
    assert dropout(x, 0.0, gen) is x and dropout(x, 0.5, gen, False) is x
    a = dropout(x, 0.5, torch.Generator().manual_seed(3))
    b = dropout(x, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


SRC_V, TGT_V, S = 20, 9, 12
DIMS = {"embedding_size": 32, "num_heads": 4, "num_layers": 2,
        "hidden_size": 32}


@pytest.mark.parametrize("tgt_input", ["label", "bos"])
def test_transformer_train_grads_match_jax(tgt_input):
    rng = np.random.default_rng(4)
    lengths = rng.integers(1, S + 1, size=6).astype(np.int32)
    lengths[0] = S
    tokens = rng.integers(2, SRC_V, size=(6, S)).astype(np.int32)
    tokens[np.arange(S)[None, :] >= lengths[:, None]] = PAD
    y = rng.integers(0, TGT_V, size=6).astype(np.int32)
    y[1] = PAD
    w = np.array([1, 1, 1, 1, 0, 1], np.float32)

    model = JaxTransformer(SRC_V, TGT_V, **DIMS, attn_backend="xla",
                           tgt_input=tgt_input, dropout=0.3)
    params = model.init({"params": jax.random.key(0)}, tokens, lengths, y)

    def loss_fn(p):
        out = model.apply(p, tokens, lengths, y, dropout_rate=0.0,
                          deterministic=True)
        return jax_losses.cross_entropy_loss(out, y, ignore_index=PAD,
                                             sample_weight=w)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    port = Transformer(SRC_V, TGT_V, **DIMS, tgt_input=tgt_input, dropout=0.3)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    port.train()
    out = port(*(torch.from_numpy(a) for a in (tokens, lengths, y)),
               dropout_rate=0.0)
    loss = losses.cross_entropy_loss(out, torch.from_numpy(y),
                                     ignore_index=PAD,
                                     sample_weight=torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)
