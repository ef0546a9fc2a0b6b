"""The port's single-head fused attention op against the JAX package's.

`sign_language_nlp_torch.ops.fused_attention_bh` is the counterpart of
sign_language_nlp_tpu/ops/pallas_attention.py's `fused_attention`: its
forward is the Pallas kernel K3, run here in interpret mode as
tests/test_pallas_attention.py runs it, and its gradient is autodiff of
`_xla_reference` through `jax.custom_vjp`. On the CPU the port's entry
point takes its plain version; the CUDA kernel runs only on the card
(chip_smoke.py), and here its wrapper is shown refusing what it does not
take.

Tolerances: forward rtol and atol 1e-5, gradients rtol 1e-4 and atol
1e-5, on N(0,1) inputs in f32. Both sides compute the same f32 math;
only the summation order differs.
"""
import jax
import numpy as np
import pytest
import torch

from sign_language_nlp_tpu.ops.attention import NEG_INF
from sign_language_nlp_tpu.ops.pallas_attention import (_xla_reference,
                                                        fused_attention)
from sign_language_nlp_torch.ops import fused_attention_bh as fab

FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# name: (BH, Sq, Sk, D, bias kind)
CASES = {
    "jax_fixture": (4, 16, 16, 8, "last4"),
    "one_query_row": (4, 1, 16, 8, "random"),
    "ragged": (6, 7, 13, 24, "causal_padding"),
    "masked_row": (4, 9, 9, 8, "masked_row"),
    "random_bias": (3, 12, 10, 16, "random"),
}


def _inputs(name):
    """q/k/v N(0,1), a per-slice bias and an N(0,1) cotangent. The
    "jax_fixture" case is tests/test_pallas_attention.py's fixture: the
    same seed and shapes, the last 4 keys masked."""
    BH, Sq, Sk, D, kind = CASES[name]
    rng = np.random.default_rng(0)
    q = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    k = rng.normal(size=(BH, Sk, D)).astype(np.float32)
    v = rng.normal(size=(BH, Sk, D)).astype(np.float32)
    if kind == "last4":
        bias = np.zeros((BH, Sq, Sk), np.float32)
        bias[:, :, -4:] = NEG_INF
    elif kind == "causal_padding":  # per-row lengths, expanded per head
        B, H = 2, BH // 2
        lengths = np.repeat(rng.integers(1, Sk + 1, size=B), H)
        keys = np.arange(Sk)[None, None, :]
        rows = np.arange(Sq)[None, :, None]
        bias = np.where((keys < lengths[:, None, None]) & (keys <= rows),
                        0.0, NEG_INF)
    else:
        bias = rng.normal(size=(BH, Sq, Sk))
        if kind == "masked_row":
            bias[1, Sq // 2] = NEG_INF
    g = rng.normal(size=(BH, Sq, D)).astype(np.float32)
    return q, k, v, bias.astype(np.float32), g


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax(name):
    q, k, v, bias, _ = _inputs(name)
    kernel = np.asarray(fused_attention(q, k, v, bias))
    xla = np.asarray(_xla_reference(q, k, v, bias))
    before = fab.fused_attention_bh_fwd.launches
    got = fab.fused_attention_bh(*_t(q, k, v, bias)).numpy()
    assert fab.fused_attention_bh_fwd.launches == before == 0
    assert got.shape == q.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kernel, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got, xla, rtol=FWD_TOL, atol=FWD_TOL)
    if CASES[name][4] == "masked_row":  # a uniform average of V, not NaN
        Sq = q.shape[1]
        np.testing.assert_allclose(got[1, Sq // 2], v[1].mean(0),
                                   rtol=FWD_TOL, atol=FWD_TOL)


def _jax_grads(q, k, v, bias, g):
    _, vjp = jax.vjp(fused_attention, q, k, v, bias)
    return [np.asarray(x) for x in vjp(g)]


def _port_grads(fn, q, k, v, bias, g, bias_grad=True):
    ts = _t(q, k, v, bias)
    for i, t in enumerate(ts):
        t.requires_grad_(i < 3 or bias_grad)
    fn(*ts).backward(torch.from_numpy(g))
    return [None if t.grad is None else t.grad.numpy() for t in ts]


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(name):
    """dq, dk, dv and dbias of the entry point (the plain version's
    autograd on the CPU) against jax.vjp of the JAX op."""
    q, k, v, bias, g = _inputs(name)
    want = _jax_grads(q, k, v, bias, g)
    got = _port_grads(fab.fused_attention_bh, q, k, v, bias, g)
    for name_, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert np.isfinite(a).all(), name_
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name_)


@pytest.mark.parametrize("bias_grad", [True, False])
def test_autograd_function_backward(monkeypatch, bias_grad):
    """FusedAttentionBH's own backward, with K3 swapped for its plain
    version (the kernel runs only on the card): the JAX VJP's dq, dk, dv
    and dbias, and no gradient for a bias that needs none."""
    monkeypatch.setattr(fab, "fused_attention_bh_fwd",
                        fab.fused_attention_bh_reference)
    q, k, v, bias, g = _inputs("random_bias")
    want = _jax_grads(q, k, v, bias, g)
    got = _port_grads(fab.FusedAttentionBH.apply, q, k, v, bias, g,
                      bias_grad)
    for name_, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name_)
    if bias_grad:
        np.testing.assert_allclose(got[3], want[3], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg="dbias")
    else:
        assert got[3] is None


def test_entry_point_gives_no_bias_gradient_when_none_is_wanted():
    q, k, v, bias, g = _inputs("ragged")
    got = _port_grads(fab.fused_attention_bh, q, k, v, bias, g,
                      bias_grad=False)
    assert got[3] is None and all(x is not None for x in got[:3])


def _refused(kind):
    """Inputs K3's wrapper must refuse, and the error it raises."""
    q, k, v, bias = _t(*_inputs("ragged")[:4])
    if kind == "cpu_tensor":
        return (q, k, v, bias), ValueError, "CUDA"
    if kind == "bf16":
        return (q.bfloat16(), k, v, bias), TypeError, "queue 1 item 14"
    if kind == "head_width_264":
        BH, Sq, Sk = bias.shape
        return ((torch.zeros(BH, Sq, 264), torch.zeros(BH, Sk, 264),
                 torch.zeros(BH, Sk, 264), bias), ValueError, "D <= 256")
    if kind == "mismatched_kv":
        return (q, k, v[:, :-1], bias), ValueError, "expected"
    if kind == "mismatched_bias":
        return (q, k, v, bias[:, :, :-1]), ValueError, "bias"
    if kind == "non_contiguous":
        kt = k.transpose(0, 1).contiguous().transpose(0, 1)
        return (q, kt, v, bias), ValueError, "contiguous"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["cpu_tensor", "bf16", "head_width_264",
                                  "mismatched_kv", "mismatched_bias",
                                  "non_contiguous"])
def test_cuda_wrapper_refuses(kind):
    args, error, match = _refused(kind)
    before = fab.fused_attention_bh_fwd.launches
    with pytest.raises(error, match=match):
        fab.fused_attention_bh_fwd(*args)
    assert fab.fused_attention_bh_fwd.launches == before == 0
