"""The port's attention against the JAX package's.

The port's plain version of the fused kernel is held against JAX's K1
(`fused_attention_train` with dropout off) run in interpret mode, as
tests/test_pallas_train.py runs it; the port's dispatch and masks are
held against sign_language_nlp_tpu.ops.attention. The CUDA kernel
itself runs only on the card (chip_smoke.py); here the wrapper's input
checks are shown refusing what the kernel does not take.

Tolerance: atol 1e-5 on N(0,1) inputs in f32. Both sides compute the
same f32 math; only the summation order differs.
"""
import numpy as np
import pytest
import torch

from sign_language_nlp_tpu.ops import attention as jax_att
from sign_language_nlp_tpu.ops.pallas_attention_train import (
    fused_attention_train)
from sign_language_nlp_torch.ops import attention as att
from sign_language_nlp_torch.ops.fused_attention import (
    fused_attention_fwd, fused_attention_reference, head_shared_bias)

B, E, H = 3, 64, 4  # D = 16, the grid's narrowest head
ATOL = 1e-5


def _inputs(Sq, Sk, bias_kind, seed=0):
    """q/k/v N(0,1) and a head-shared bias [B,Sq,Sk]:
    "zero"; "causal_padding" (per-row valid lengths, plus a causal mask
    when Sq == Sk, so masked cells reach -2e30); "masked_row" (zero, but
    batch row 1 is all NEG_INF, which must average V uniformly)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, E)).astype(np.float32)
    k = rng.normal(size=(B, Sk, E)).astype(np.float32)
    v = rng.normal(size=(B, Sk, E)).astype(np.float32)
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
    return q, k, v, bias.astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bias_kind", ["zero", "causal_padding",
                                       "masked_row"])
@pytest.mark.parametrize("Sq,Sk", [(12, 12), (1, 1), (1, 12), (7, 9)])
def test_reference_matches_jax_k1(Sq, Sk, bias_kind):
    q, k, v, bias = _inputs(Sq, Sk, bias_kind)
    seeds = np.zeros((B,), np.int32)
    rate = np.zeros((1,), np.float32)
    want = np.asarray(fused_attention_train(q, k, v, bias, seeds, rate,
                                            False, H))
    got = fused_attention_reference(*_t(q, k, v, bias), H).numpy()
    assert got.shape == (B, Sq, E) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if bias_kind == "masked_row":  # uniform average of V, not NaN or 0
        np.testing.assert_allclose(
            got[1], np.broadcast_to(v[1].mean(0), (Sq, E)), rtol=0,
            atol=ATOL)


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("bias_shape", ["none", "padding", "causal",
                                        "causal_padding"])
def test_multi_head_attention_matches_jax(backend, bias_shape):
    """The dispatch with the framework's 4-D biases; on CPU tensors every
    backend takes the plain version."""
    S = 10
    q, k, v, _ = _inputs(S, S, "zero", seed=1)
    valid = np.ones((B, S), bool)
    valid[1, 6:] = False
    valid[2, :] = False  # a row with no real token
    pad = np.asarray(jax_att.padding_bias(valid))
    causal = np.asarray(jax_att.causal_bias(S))
    bias = {"none": None, "padding": pad, "causal": causal,
            "causal_padding": pad + causal}[bias_shape]
    want = np.asarray(jax_att.multi_head_attention(
        q, k, v, bias, num_heads=H, backend="xla"))
    tb = None if bias is None else torch.from_numpy(bias.copy())
    got = att.multi_head_attention(*_t(q, k, v), tb, num_heads=H,
                                   backend=backend).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("backend", ["xla", "auto", "pallas"])
def test_per_head_bias_matches_jax(backend):
    """A per-head bias [B,H,Sq,Sk], added before the softmax as the
    einsum path adds it (sign_language_nlp_tpu/ops/attention.py:82-83),
    with one head's row fully masked. On CPU tensors every backend takes
    the plain version."""
    Sq, Sk = 5, 7
    q, k, v, _ = _inputs(Sq, Sk, "zero", seed=3)
    bias = np.random.default_rng(4).normal(size=(B, H, Sq, Sk))
    bias[0, 1, :, -2:] = jax_att.NEG_INF
    bias[2, 3, 1] = jax_att.NEG_INF
    bias = bias.astype(np.float32)
    want = np.asarray(jax_att.multi_head_attention(
        q, k, v, bias, num_heads=H, backend="xla"))
    got = att.multi_head_attention(*_t(q, k, v, bias), num_heads=H,
                                   backend=backend).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_per_head_bias_refused_on_the_kernel_path(backend):
    """Off the CPU the kernels take a head-shared bias only. "pallas"
    goes to them whatever the bias, so a per-head one raises before any
    launch and names the backend that takes it; "auto" sends a per-head
    bias to the plain version instead. A head-shared bias goes to the
    kernel path under both. A meta tensor stands in for a CUDA one,
    which this build of torch may not make; the checks come before the
    device, so the same happens on the card."""
    q = torch.empty(B, 4, E, device="meta")
    per_head = torch.zeros(B, H, 4, 4, device="meta")
    before = fused_attention_fwd.launches
    if backend == "pallas":
        with pytest.raises(ValueError, match='per head.*backend="xla"'):
            att.multi_head_attention(q, q, q, per_head, num_heads=H,
                                     backend=backend)
    else:
        out = att.multi_head_attention(q, q, q, per_head, num_heads=H,
                                       backend=backend)
        assert out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA device"):  # the kernel path
        att.multi_head_attention(q, q, q, per_head[:, :1], num_heads=H,
                                 backend=backend)
    assert fused_attention_fwd.launches == before
    out = att.multi_head_attention(q, q, q, per_head, num_heads=H,
                                   backend="xla")
    assert out.shape == q.shape


@pytest.mark.parametrize("backend", ["xla", "auto", "pallas"])
def test_3d_bias_is_per_head_as_in_jax(backend):
    """A 3-D bias [H,Sq,Sk] broadcasts to [1,H,Sq,Sk], one slice per
    head, as in the JAX package; with B == H it must not be read as one
    slice per batch row. On CPU tensors every backend takes the plain
    version."""
    Bh, Eh, S = 4, 16, 5  # B = H = 4, D 4
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(Bh, S, Eh)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(Bh, S, S)).astype(np.float32)
    bias[2, :, -2:] = jax_att.NEG_INF
    want = np.asarray(jax_att.multi_head_attention(
        q, k, v, bias, num_heads=Bh, backend="xla"))
    got = att.multi_head_attention(*_t(q, k, v, bias), num_heads=Bh,
                                   backend=backend).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("case", ["D8", "D12", "D256", "per_head", "D320"])
def test_auto_on_cuda_routes_to_kernels_where_they_take_the_input(case):
    """"auto" on CUDA goes to the kernels for every input they take (any
    D <= 256, a head-shared bias) and to the plain version otherwise;
    "pallas" goes to the kernels always. The choice is a pure function of
    shapes and device type, so it is asked here with "cuda" itself, and
    shown through the dispatch with meta tensors standing in for CUDA
    ones: the kernel path raises at the device check, past every shape
    check, and the plain path returns."""
    E_, H_, per_head = {"D8": (32, 4, False), "D12": (48, 4, False),
                        "D256": (512, 2, False), "per_head": (64, 4, True),
                        "D320": (640, 2, False)}[case]
    plain = per_head or E_ // H_ > 256
    assert att.attention_route("auto", "cuda", E_ // H_, per_head) == (
        "plain" if plain else "kernel")
    assert att.attention_route("pallas", "cuda", E_ // H_,
                               per_head) == "kernel"
    assert att.attention_route("xla", "cuda", E_ // H_, per_head) == "plain"
    assert att.attention_route("auto", "cpu", E_ // H_, per_head) == "plain"
    q = _meta(2, 3, E_)
    bias = _meta(2, H_ if per_head else 1, 3, 3)
    before = fused_attention_fwd.launches
    if plain:
        out = att.multi_head_attention(q, q, q, bias, num_heads=H_)
        assert out.shape == q.shape
        with pytest.raises(ValueError, match="per head|head width"):
            att.multi_head_attention(q, q, q, bias, num_heads=H_,
                                     backend="pallas")
    else:
        with pytest.raises(ValueError, match="CUDA device"):
            att.multi_head_attention(q, q, q, bias, num_heads=H_)
    assert fused_attention_fwd.launches == before


def test_masks_match_jax():
    valid = np.array([[True, True, False], [False, False, False]])
    np.testing.assert_array_equal(
        att.padding_bias(torch.from_numpy(valid)).numpy(),
        np.asarray(jax_att.padding_bias(valid)))
    np.testing.assert_array_equal(att.causal_bias(5).numpy(),
                                  np.asarray(jax_att.causal_bias(5)))
    assert att.NEG_INF == jax_att.NEG_INF


def test_head_shared_bias_broadcasts():
    pad = torch.tensor([[0.0, att.NEG_INF]])[:, None, None, :]  # [1,1,1,2]
    out = head_shared_bias(pad, 2, 3, 2, torch.device("cpu"))
    assert out.shape == (2, 3, 2) and out.is_contiguous()
    assert out.dtype == torch.float32
    assert torch.equal(out[1, 2], torch.tensor([0.0, att.NEG_INF]))
    zeros = head_shared_bias(None, 2, 1, 4, torch.device("cpu"))
    assert torch.equal(zeros, torch.zeros(2, 1, 4))
    with pytest.raises(ValueError, match="per head"):
        head_shared_bias(torch.zeros(2, H, 3, 2), 2, 3, 2,
                         torch.device("cpu"))


def test_cpu_path_does_not_launch():
    q, k, v, bias = _t(*_inputs(4, 4, "zero"))
    before = fused_attention_fwd.launches
    att.multi_head_attention(q, k, v, None, num_heads=H, backend="auto")
    att.multi_head_attention(q, k, v, bias[:, None], num_heads=H,
                             backend="pallas")
    assert fused_attention_fwd.launches == before


def test_head_shared_bias_is_used_as_it_is():
    """The [B,1,Sq,Sk] view of a bias already in the kernel's [B,Sq,Sk]
    f32 layout, as the Transformer passes it, is neither copied nor read
    as per-head, and gives what a copy of it gives."""
    q, k, v, bias = _t(*_inputs(5, 5, "causal_padding", seed=2))
    same = head_shared_bias(bias[:, None], B, 5, 5, q.device)
    assert same.data_ptr() == bias.data_ptr() and same.shape == bias.shape
    got = att.multi_head_attention(q, k, v, bias[:, None], num_heads=H)
    want = att.multi_head_attention(q, k, v, bias[:, None].clone(),
                                    num_heads=H)
    assert torch.equal(got, want)


def test_reference_takes_the_kernels_bias_or_a_4d_one():
    """The plain version takes the bias as its callers pass it: the
    kernels' head-shared [B,Sq,Sk] (the same as its [B,1,Sq,Sk] form) or
    4-D; any other 3-D or a 2-D bias is refused, never guessed."""
    q, k, v, bias = _t(*_inputs(5, 5, "causal_padding", seed=5))
    got = fused_attention_reference(q, k, v, bias, H)
    assert torch.equal(got, fused_attention_reference(q, k, v, bias[:, None],
                                                      H))
    for bad in (bias[:1], bias[0]):  # [1,Sq,Sk], [Sq,Sk]
        with pytest.raises(ValueError, match="bias"):
            fused_attention_reference(q, k, v, bad, H)
    with pytest.raises(ValueError, match="at most 4"):
        att.multi_head_attention(q, k, v, bias[None, None], num_heads=H)


def test_dispatch_refusals():
    q = torch.zeros(1, 2, E)
    with pytest.raises(ValueError, match="seeds"):
        att.multi_head_attention(q, q, q, num_heads=H, dropout_rate=0.1)
    with pytest.raises(ValueError, match="backend"):
        att.multi_head_attention(q, q, q, num_heads=H, backend="flash")
    with pytest.raises(ValueError, match="divide"):
        att.multi_head_attention(q, q, q, num_heads=3)


def _case(kind):
    """Inputs the CUDA wrapper must refuse, and the error it raises."""
    q, k, v, bias = _t(*_inputs(4, 6, "zero"))
    if kind == "cpu_tensor":
        return (q, k, v, bias, H), ValueError, "CUDA"
    if kind == "bf16":
        return (q.bfloat16(), k, v, bias, H), TypeError, "float32"
    if kind == "f64_bias":
        return (q, k, v, bias.double(), H), TypeError, "float32"
    if kind == "non_contiguous":
        kt = k.transpose(0, 1).contiguous().transpose(0, 1)
        return (q, kt, v, bias, H), ValueError, "contiguous"
    if kind == "bias_shape":
        return (q, k, v, bias[:, :1], H), ValueError, "bias"
    if kind == "head_width":  # D 320 > 256
        wide = torch.zeros(B, 4, 640)
        return (wide, wide[:, :1].expand(B, 6, 640).contiguous(),
                wide[:, :1].expand(B, 6, 640).contiguous(), bias, 2), \
            ValueError, "head width"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["cpu_tensor", "bf16", "f64_bias",
                                  "non_contiguous", "bias_shape",
                                  "head_width"])
def test_cuda_wrapper_refuses(kind):
    args, error, match = _case(kind)
    before = fused_attention_fwd.launches
    with pytest.raises(error, match=match):
        fused_attention_fwd(*args)
    assert fused_attention_fwd.launches == before


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    from sign_language_nlp_torch.kernels import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
