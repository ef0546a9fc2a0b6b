"""The port's training attention against the JAX package's.

Dropout off: the port's plain forward and its autograd gradients are
held against K1 (`fused_attention_train(..., use_dropout=False)`) and
`jax.vjp` through it, which runs K2's Pallas body in interpret mode, as
tests/test_pallas_train.py runs them. Tolerance rtol 1e-4, atol 1e-5:
the same f32 math, summed in another order.

Dropout on: the TPU kernels draw their mask from the TPU's generator,
which neither the CPU nor the port has, so the port's plain version
with `dropout_keep_mask`'s mask is held against a same-mask einsum
written here with `jax.vjp`, as scripts/validate_pallas_tpu.py:71-89
holds the TPU kernel. The mask itself is checked for determinism, for
its dependence on every coordinate, and for its keep fraction. The CUDA
kernels run only on the card (chip_smoke.py); here their wrappers are
shown refusing what they do not take.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sign_language_nlp_tpu.ops import attention as jax_att
from sign_language_nlp_tpu.ops.pallas_attention_train import (
    fused_attention_train)
from sign_language_nlp_torch.ops import attention as att
from sign_language_nlp_torch.ops import fused_attention as fa

B, E, H = 3, 64, 4  # D = 16
D = E // H
RTOL, ATOL = 1e-4, 1e-5


def _inputs(Sq, Sk, bias_kind, seed=0):
    """q/k/v N(0,1), a head-shared bias [B,Sq,Sk] ("zero",
    "causal_padding", or "masked_row": batch row 1 all NEG_INF) and an
    N(0,1) cotangent for the output."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, E)).astype(np.float32)
    k = rng.normal(size=(B, Sk, E)).astype(np.float32)
    v = rng.normal(size=(B, Sk, E)).astype(np.float32)
    g = rng.normal(size=(B, Sq, E)).astype(np.float32)
    bias = np.zeros((B, Sq, Sk), np.float32)
    if bias_kind == "causal_padding":
        lengths = rng.integers(1, Sk + 1, size=B)
        lengths[0] = Sk
        bias += np.where(np.arange(Sk)[None, None, :]
                         < lengths[:, None, None], 0.0, jax_att.NEG_INF)
        if Sq == Sk:
            bias += np.triu(np.full((Sq, Sk), jax_att.NEG_INF, np.float32),
                            1)
    elif bias_kind == "masked_row":
        bias[1] = jax_att.NEG_INF
    return q, k, v, bias.astype(np.float32), g


def _port_vjp(q, k, v, bias, g, keep=None, rate=0.0):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.fused_attention_reference(qt, kt, vt, torch.from_numpy(bias), H,
                                       keep, rate)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


@pytest.mark.parametrize("bias_kind", ["zero", "causal_padding",
                                       "masked_row"])
@pytest.mark.parametrize("Sq,Sk", [(12, 12), (1, 1), (1, 12), (7, 9)])
def test_dropout_off_matches_jax_k1_k2(Sq, Sk, bias_kind):
    q, k, v, bias, g = _inputs(Sq, Sk, bias_kind)
    seeds = np.zeros((B,), np.int32)
    rate = np.zeros((1,), np.float32)
    want, vjp = jax.vjp(lambda q, k, v: fused_attention_train(
        q, k, v, bias, seeds, rate, False, H), q, k, v)
    want_grads = vjp(g)
    got, got_grads = _port_vjp(q, k, v, bias, g)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    for name, a, b in zip("qkv", got_grads, want_grads):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


def _jax_same_mask(q, k, v, bias, keep, rate):
    """scripts/validate_pallas_tpu.py:71-80: the einsum path with an
    injected mask, scaled as K1 scales it."""
    Sq, Sk = q.shape[1], k.shape[1]
    inv = 1.0 / jnp.maximum(1.0 - jnp.float32(rate), 1e-6)
    qh = q.reshape(B, Sq, H, D).transpose(0, 2, 1, 3)
    kh = k.reshape(B, Sk, H, D).transpose(0, 2, 1, 3)
    vh = v.reshape(B, Sk, H, D).transpose(0, 2, 1, 3)
    s = jnp.einsum("bhqd,bhkd->bhqk", qh, kh) / np.sqrt(D) + bias[:, None]
    p = jnp.where(keep, jax.nn.softmax(s, -1) * inv, 0.0)
    o = jnp.einsum("bhqk,bhkd->bhqd", p, vh)
    return o.transpose(0, 2, 1, 3).reshape(B, Sq, E)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("Sq,Sk,bias_kind", [(12, 12, "causal_padding"),
                                             (1, 12, "zero"),
                                             (7, 9, "masked_row")])
def test_dropout_on_matches_same_mask_einsum(Sq, Sk, bias_kind, rate):
    q, k, v, bias, g = _inputs(Sq, Sk, bias_kind, seed=1)
    seeds = torch.tensor([7, 2 ** 31 - 2, 12345], dtype=torch.int32)
    keep = fa.dropout_keep_mask(seeds, H, Sq, Sk, rate)
    want, vjp = jax.vjp(lambda q, k, v: _jax_same_mask(
        q, k, v, bias, keep.numpy(), rate), q, k, v)
    got, got_grads = _port_vjp(q, k, v, bias, g, keep, rate)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    for name, a, b in zip("qkv", got_grads, vjp(g)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")
    # The dispatch's plain path draws the same mask from the same seeds:
    routed = att.multi_head_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(bias)[:, None], num_heads=H, backend="xla",
        dropout_rate=rate, seeds=seeds)
    np.testing.assert_array_equal(routed.numpy(), got)


def test_keep_mask_is_deterministic_and_keyed_by_every_coordinate():
    seeds = torch.tensor([11, 12], dtype=torch.int32)
    m = fa.dropout_keep_mask(seeds, 3, 16, 16, 0.5)
    assert m.shape == (2, 3, 16, 16) and m.dtype == torch.bool
    assert torch.equal(m, fa.dropout_keep_mask(seeds, 3, 16, 16, 0.5))
    other = fa.dropout_keep_mask(seeds + 1, 3, 16, 16, 0.5)
    assert not torch.equal(m, other)           # seed
    assert not torch.equal(m[0], m[1])         # batch row (its seed)
    assert not torch.equal(m[:, 0], m[:, 1])   # head
    assert not torch.equal(m[:, :, 0], m[:, :, 1])        # query i
    assert not torch.equal(m[..., 0], m[..., 1])          # key j
    # A bigger grid holds the smaller one: the mask of (seed, h, i, j)
    # does not depend on the shapes around it (K2 replays it tiled).
    big = fa.dropout_keep_mask(seeds, 4, 40, 33, 0.5)
    assert torch.equal(big[:, :3, :16, :16], m)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_keep_fraction(rate):
    seeds = torch.arange(40, dtype=torch.int32) * 7919
    m = fa.dropout_keep_mask(seeds, 8, 60, 60, rate)
    assert m.numel() >= 10 ** 6
    assert abs(float(m.float().mean()) - (1 - rate)) <= 0.01


def test_keep_mask_edges():
    seeds = torch.tensor([3], dtype=torch.int32)
    assert bool(fa.dropout_keep_mask(seeds, 2, 5, 5, 0.0).all())
    assert not bool(fa.dropout_keep_mask(seeds, 2, 5, 5, 1.0).any())
    assert fa.dropout_threshold(0.5) == 2 ** 23
    assert fa.dropout_inv(1.0) == pytest.approx(1e6)
    # int32 seeds of either sign hash as their 32-bit patterns:
    neg = fa.dropout_keep_mask(torch.tensor([-1], dtype=torch.int32), 1, 4,
                               4, 0.5)
    assert neg.shape == (1, 1, 4, 4)


def _bwd_args(kind):
    q, k, v, bias, g = (torch.from_numpy(a) for a in _inputs(4, 6, "zero"))
    stats = torch.zeros(B, H, 4, 2)
    seeds = torch.zeros(B, dtype=torch.int32)
    args = dict(q=q, k=k, v=v, bias=bias, dout=g, stats=stats,
                num_heads=H, seeds=seeds, rate=0.1)
    if kind == "cpu_tensor":
        return args, ValueError, "CUDA"
    if kind == "no_seeds":
        return {**args, "seeds": None}, ValueError, "seeds"
    if kind == "seeds_dtype":
        return {**args, "seeds": seeds.long()}, ValueError, "seeds"
    if kind == "rate":
        return {**args, "rate": 1.5}, ValueError, "rate"
    if kind == "dout_shape":
        return {**args, "dout": g[:, :1]}, ValueError, "dout"
    if kind == "bf16_dout":
        return {**args, "dout": g.bfloat16()}, TypeError, "float32"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["cpu_tensor", "no_seeds", "seeds_dtype",
                                  "rate", "dout_shape", "bf16_dout"])
def test_cuda_wrappers_refuse(kind):
    args, error, match = _bwd_args(kind)
    before = (fa.fused_attention_fwd.launches,
              fa.fused_attention_bwd.launches)
    with pytest.raises(error, match=match):
        fa.fused_attention_bwd(**args)
    fwd_args = {k: args[k] for k in ("q", "k", "v", "bias", "num_heads",
                                     "seeds", "rate")}
    if kind not in ("dout_shape", "bf16_dout"):
        with pytest.raises(error, match=match):
            fa.fused_attention_fwd(**fwd_args)
    assert (fa.fused_attention_fwd.launches,
            fa.fused_attention_bwd.launches) == before


def test_cpu_training_attention_takes_the_plain_path():
    """On CPU tensors every backend takes the plain version, with its
    autograd backward, and launches nothing."""
    q, k, v, bias, g = _inputs(5, 5, "causal_padding", seed=3)
    seeds = torch.tensor([1, 2, 3], dtype=torch.int32)
    before = (fa.fused_attention_fwd.launches,
              fa.fused_attention_bwd.launches)
    outs = []
    for backend in ("auto", "pallas", "xla"):
        qt = torch.from_numpy(q).requires_grad_()
        out = att.multi_head_attention(qt, *(torch.from_numpy(a)
                                             for a in (k, v)),
                                       torch.from_numpy(bias)[:, None],
                                       num_heads=H, backend=backend,
                                       dropout_rate=0.3, seeds=seeds)
        (dq,) = torch.autograd.grad(out, qt, torch.from_numpy(g))
        outs.append((out.detach(), dq))
    for out, dq in outs[1:]:
        assert torch.equal(out, outs[0][0]) and torch.equal(dq, outs[0][1])
    assert (fa.fused_attention_fwd.launches,
            fa.fused_attention_bwd.launches) == before
