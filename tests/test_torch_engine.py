"""The port's PopulationTrainer against the JAX package's, from the same
weights.

A population of two cells (learning rates 0.5 and 0.05, dropout 0) fits
a small learnable task on both sides: the JAX engine with
`train_deterministic=True` and `attn_backend="xla"` (the Pallas kernels
in interpret mode inside the epoch scan would cost minutes; the
attention kernels' own parity is tests/test_torch_attention_train.py),
the port on the CPU from the same stacked weights carried across by
`params_from_jax_population`. The per-epoch train and valid losses agree
within 2e-3 while a cell is live, and every cell stops at the same epoch
(cell 0 early-stops, cell 1 runs to max_epochs), as in the
tests/test_torch_ab.py pattern. After its stop a cell is frozen: the
JAX program keeps scoring it at lr 0, the port repeats its last row.

Then the port alone: a cell's fit does not depend on the population it
is packed in, a dropout fit repeats under the same seed, and what is
not ported yet, or asks for a missing card, raises.
"""
import jax
import numpy as np
import pytest
import torch

from sign_language_nlp_tpu.models.registry import build_model as jax_build
from sign_language_nlp_tpu.search import kfold as jax_kfold
from sign_language_nlp_tpu.training.engine import (
    PopulationTrainer as JaxTrainer)
from sign_language_nlp_tpu.training.engine import TrainConfig as JaxConfig
from sign_language_nlp_tpu.training.engine import TrainTask as JaxTask
from sign_language_nlp_torch.models.convert import params_from_jax_population
from sign_language_nlp_torch.models.registry import build_model
from sign_language_nlp_torch.search import kfold
from sign_language_nlp_torch.training.engine import (PopulationTrainer,
                                                     TrainConfig, TrainTask,
                                                     predict_log_probs)

VS, VT, PAD = 14, 8, 1
N, N_TRAIN = 44, 32
MODEL_ARGS = {"embedding_size": 16, "num_heads": 2, "num_layers": 1,
              "hidden_size": 16, "dropout": 0.0}
COMPAT = {"tgt_input": "bos", "attn_backend": "xla"}
SETTINGS = dict(batch_size=16, max_epochs=12, seed=0, verbose=0,
                optimizer_args={"momentum": 0.9},
                gradient_clipping={"gradient_clip_value": 0.5},
                lr_scheduler={"factor": 0.2, "patience": 1,
                              "threshold": 1e-4},
                early_stopping={"patience": 2, "threshold": 1e-4},
                scoring=("accuracy", "neg_log_loss"))
LRS = (0.5, 0.05)
TOL = 2e-3


def _data(seed=0):
    """A class signal on every other token plus noise: learnable, not
    saturated at once (tests/test_torch_ab.py:_data)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(2, VT, N).astype(np.int32)
    tokens = np.full((N, 10), PAD, np.int32)
    lengths = rng.integers(3, 11, N).astype(np.int32)
    for i in range(N):
        row = rng.integers(2, VS, lengths[i])
        row[::2] = 2 + (y[i] - 2) % (VS - 2)
        tokens[i, :lengths[i]] = row
    return tokens, lengths, y


def _task(cls, P=len(LRS), lrs=LRS, dropout=0.0, seed_ids=None):
    rows = np.arange(N)
    return cls(train_rows=[rows[:N_TRAIN]] * P, valid_rows=[rows[N_TRAIN:]] * P,
               lr=np.asarray(lrs, np.float32),
               dropout=np.full(P, dropout, np.float32),
               **({} if seed_ids is None else {"seed_ids": seed_ids}))


def _factory(gen):
    return build_model("model.Transformer", VS, VT, PAD, PAD,
                       model_args=MODEL_ARGS, compat_args=COMPAT,
                       generator=gen)


def _trainer(**overrides):
    cfg = TrainConfig(**{**SETTINGS, "device": "cpu", **overrides})
    return PopulationTrainer(_factory, PAD, VT, cfg)


@pytest.fixture(scope="module")
def both_fits():
    data = _data()
    model = jax_build("model.Transformer", VS, VT, PAD, PAD,
                      model_args=MODEL_ARGS, compat_args=COMPAT)
    cells = [model.init({"params": jax.random.key(i)}, *(a[:4] for a in data))
             for i in range(len(LRS))]
    stacked = jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                           *cells)
    jax_out = JaxTrainer(model, PAD, VT,
                         JaxConfig(**SETTINGS, train_deterministic=True)
                         ).fit(data, _task(JaxTask), init_params=stacked)
    port_out = _trainer(train_deterministic=True).fit(
        data, _task(TrainTask), init_params=params_from_jax_population(
            stacked))
    return data, stacked, jax_out, port_out


def test_fit_matches_jax_engine(both_fits):
    _, _, jax_out, port_out = both_fits
    j, p = jax_out["history"], port_out["history"]
    assert set(j) == set(p)
    assert all(v.shape == (SETTINGS["max_epochs"], len(LRS))
               for v in p.values())
    j_stop, p_stop = np.asarray(j["stopped"]), p["stopped"]
    np.testing.assert_array_equal(p_stop, j_stop)
    assert j_stop[:, 0].any() and not j_stop[:, 1].any()  # both regimes
    np.testing.assert_array_equal(port_out["epochs_run"],
                                  np.asarray(jax_out["epochs_run"]))
    for c in range(len(LRS)):
        live = int(port_out["epochs_run"][c])
        for key in ("train_loss", "valid_loss", "valid_accuracy",
                    "valid_neg_log_loss"):
            np.testing.assert_allclose(p[key][:live, c],
                                       np.asarray(j[key])[:live, c],
                                       rtol=TOL, atol=TOL, err_msg=key)
        np.testing.assert_allclose(p["lr"][:, c], np.asarray(j["lr"])[:, c],
                                   rtol=1e-6)
    for field, a, b in zip(port_out["monitor"]._fields, port_out["monitor"],
                           jax_out["monitor"]):
        if field in ("lr", "stopped", "epoch", "es_misses", "plateau_bad"):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)
        else:
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL,
                                       err_msg=field)
    # A stopped cell's history after the stop repeats its last row:
    stop = int(port_out["epochs_run"][0])
    assert (p["valid_loss"][stop:, 0] == p["valid_loss"][stop - 1, 0]).all()


def test_best_params_and_predict_match_jax(both_fits):
    """The best-params snapshots (the valid-loss checkpoint) predict the
    same log-probs on both sides."""
    data, _, jax_out, port_out = both_fits
    rows = [np.arange(N_TRAIN, N)] * len(LRS)
    model = jax_build("model.Transformer", VS, VT, PAD, PAD,
                      model_args=MODEL_ARGS, compat_args=COMPAT)
    want, want_w = JaxTrainer(model, PAD, VT, JaxConfig(eval_batch_size=5)
                              ).predict_log_probs(jax_out["best_params"],
                                                  data, rows)
    got, got_w = predict_log_probs(_factory, port_out["best_params"], data,
                                   rows, PAD, VT, batch_size=5, device="cpu")
    assert got.shape == (len(LRS), N - N_TRAIN, VT)
    np.testing.assert_array_equal(got_w, np.asarray(want_w))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=5e-3)


def test_stopped_cell_params_are_frozen_at_the_stop(both_fits):
    """The port skips a stopped cell; the JAX program steps it at lr 0,
    which leaves its params where they were: the same params on both
    sides, within the fit's f32 drift."""
    _, _, jax_out, port_out = both_fits
    want = params_from_jax_population(jax.tree.map(np.asarray,
                                                   jax_out["params"]))
    for name, t in port_out["params"][0].items():
        np.testing.assert_allclose(t.numpy(), want[0][name].numpy(),
                                   rtol=0, atol=5e-3, err_msg=name)


def test_cell_fit_is_independent_of_its_population():
    data = _data(1)
    alone = _trainer(max_epochs=2).fit(
        data, _task(TrainTask, P=1, lrs=(0.2,), dropout=0.3, seed_ids=[5]))
    packed = _trainer(max_epochs=2).fit(
        data, _task(TrainTask, P=3, lrs=(0.5, 0.2, 0.05), dropout=0.3,
                    seed_ids=[3, 5, 7]))
    for key, hist in alone["history"].items():
        np.testing.assert_array_equal(hist[:, 0], packed["history"][key][:, 1],
                                      err_msg=key)
    for name, t in alone["params"][0].items():
        assert torch.equal(t, packed["params"][1][name]), name


def test_dropout_fit_is_finite_and_repeats():
    data = _data(2)
    fits = [_trainer(max_epochs=3).fit(data, _task(TrainTask, dropout=0.5))
            for _ in range(2)]
    for key, hist in fits[0]["history"].items():
        assert np.isfinite(hist.astype(np.float64)).all(), key
        np.testing.assert_array_equal(hist, fits[1]["history"][key],
                                      err_msg=key)
    off = _trainer(max_epochs=3).fit(data, _task(TrainTask))
    assert not np.array_equal(off["history"]["train_loss"],
                              fits[0]["history"]["train_loss"])
    assert fits[0]["steps"] == 3 * len(LRS) * 2  # 32 rows, batch 16


@pytest.mark.parametrize("n_splits,stratified", [(5, True), (3, True),
                                                  (5, False)])
def test_monitor_split_matches_jax(n_splits, stratified):
    """The port's copy of search/kfold.py gives the JAX package's folds
    (which tests/test_search.py holds to sklearn's)."""
    y = np.random.default_rng(3).integers(0, 6, 57)
    got = kfold.train_valid_split(y, n_splits, stratified)
    want = jax_kfold.train_valid_split(y, n_splits, stratified)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for (a, b), (c, d) in zip(kfold.stratified_kfold(y, n_splits),
                              jax_kfold.stratified_kfold(y, n_splits)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_device_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PopulationTrainer(_factory, PAD, VT, TrainConfig(**SETTINGS)).fit(
            _data(), _task(TrainTask))


@pytest.mark.parametrize("field,value", [("shuffle", True), ("remat", True),
                                         ("compact", True),
                                         ("length_bucketing", True),
                                         ("epoch_block", 8)])
def test_features_not_ported_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        _trainer(**{field: value})


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="mesh"):
        PopulationTrainer(_factory, PAD, VT, TrainConfig(device="cpu"),
                          mesh=object())
