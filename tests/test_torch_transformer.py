"""The port's Transformer against the JAX package's, on the same weights.

Weights come from the JAX model's own init and cross over through
`params_from_jax`; inputs are made with numpy from a seed. The JAX side
runs under attn_backend "xla" and "pallas" (K1 in interpret mode), for
every combination of the reference's quirk flags, and from a
`scan_layers` tree. Sizes: E 32, H 4, L 2, FF 32, S 12.

Tolerance: log-probs atol 1e-4 (f32 through 2+2 post-LN layers; the
two frameworks sum matmuls in different orders).
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from sign_language_nlp_tpu.models.positional import (
    sinusoidal_positional_encoding as jax_pe)
from sign_language_nlp_tpu.models.transformer import (
    Transformer as JaxTransformer)
from sign_language_nlp_torch.models.convert import params_from_jax
from sign_language_nlp_torch.models.positional import (
    sinusoidal_positional_encoding)
from sign_language_nlp_torch.models.registry import build_model
from sign_language_nlp_torch.models.transformer import Transformer

SRC_V, TGT_V, B, S = 20, 9, 5, 12
DIMS = {"embedding_size": 32, "num_heads": 4, "num_layers": 2,
        "hidden_size": 32}
ATOL = 1e-4


def _batch(seed=0):
    """Tokens with padding (pad index 1): one full row, one row of pads
    only, ragged rows between; labels including the pad index, which
    masks the decoder's only key."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    lengths[0], lengths[1] = S, 0
    tokens = rng.integers(2, SRC_V, size=(B, S)).astype(np.int32)
    tokens[np.arange(S)[None, :] >= lengths[:, None]] = 1
    y = rng.integers(0, TGT_V, size=B).astype(np.int32)
    y[2] = 1
    return tokens, lengths, y


def _jax_logprobs(flags, backend, scan_layers=False):
    model = JaxTransformer(SRC_V, TGT_V, **DIMS, attn_backend=backend,
                           scan_layers=scan_layers, **flags)
    tokens, lengths, y = _batch()
    params = model.init({"params": jax.random.key(0)}, tokens, lengths, y)
    out = np.asarray(model.apply(params, tokens, lengths, y))
    return params, out


def _port_logprobs(params, flags, backend="auto"):
    model = Transformer(SRC_V, TGT_V, **DIMS, attn_backend=backend, **flags)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    model.eval()
    tokens, lengths, y = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad():
        return model(tokens, lengths, y).numpy()


FLAG_GRID = [dict(causal_encoder=c, mask_memory=m, tgt_input=t)
             for c, m, t in itertools.product((True, False), (False, True),
                                              ("label", "bos"))]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("flags", FLAG_GRID,
                         ids=lambda f: "-".join(f"{k}={v}"
                                                for k, v in f.items()))
def test_transformer_matches_jax(flags, backend):
    params, want = _jax_logprobs(flags, backend)
    got = _port_logprobs(params, flags, backend)
    assert got.shape == (B, TGT_V) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_scan_layers_tree_matches_jax():
    flags = FLAG_GRID[0]
    params, want = _jax_logprobs(flags, "xla", scan_layers=True)
    assert "encoder_layers" in params["params"]  # a stacked [L, ...] tree
    np.testing.assert_allclose(_port_logprobs(params, flags), want, rtol=0,
                               atol=ATOL)


def test_population_axis_is_stripped():
    params, _ = _jax_logprobs(FLAG_GRID[0], "xla")
    plain = params_from_jax(jax.tree.map(np.asarray, params))
    stacked = params_from_jax(jax.tree.map(lambda a: np.asarray(a)[None],
                                           params))
    assert plain.keys() == stacked.keys()
    for key in plain:
        assert torch.equal(plain[key], stacked[key]), key
    two = jax.tree.map(lambda a: np.stack([np.asarray(a)] * 2), params)
    with pytest.raises(ValueError, match="population"):
        params_from_jax(two)


def test_converted_tree_matches_port_layout():
    """Every port parameter comes from the flax tree with its shape (Dense
    kernels transposed), and nothing is left over."""
    params, _ = _jax_logprobs(FLAG_GRID[0], "xla")
    converted = params_from_jax(jax.tree.map(np.asarray, params))
    port = Transformer(SRC_V, TGT_V, **DIMS).state_dict()
    assert converted.keys() == port.keys()
    for key, value in port.items():
        assert converted[key].shape == value.shape, key
    kernel = np.asarray(params["params"]["head"]["kernel"])
    np.testing.assert_array_equal(converted["head.weight"].numpy(),
                                  kernel.T)


def test_positional_encoding_matches_jax():
    np.testing.assert_array_equal(
        sinusoidal_positional_encoding(17, 32).numpy(),
        np.asarray(jax_pe(17, 32)))


def test_init_is_seeded_and_torch_like():
    a = Transformer(SRC_V, TGT_V, **DIMS,
                    generator=torch.Generator().manual_seed(3))
    b = Transformer(SRC_V, TGT_V, **DIMS,
                    generator=torch.Generator().manual_seed(3))
    c = Transformer(SRC_V, TGT_V, **DIMS,
                    generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["head.weight"], sc["head.weight"])
    d, ff = DIMS["embedding_size"], DIMS["hidden_size"]
    xavier = (6.0 / (d + ff)) ** 0.5
    w = sa["encoder_layers.0.ff.linear1.weight"]
    assert w.abs().max() <= xavier and w.abs().max() > 0.9 * xavier
    assert sa["head.weight"].abs().max() <= d ** -0.5
    emb = sa["src_embedding.weight"]
    assert abs(float(emb.std()) - 1.0) < 0.2
    assert torch.equal(sa["encoder_norm.weight"], torch.ones(d))


def test_training_mode_raises():
    """Training mode used to raise; it now runs dropout at the call's
    rate, drawn from the call's generator, and `eval()` turns it off."""
    model = Transformer(SRC_V, TGT_V, **DIMS)
    tokens, lengths, y = (torch.from_numpy(a) for a in _batch())
    with torch.no_grad():
        model.eval()
        want = model(tokens, lengths, y)
        model.train()
        same = model(tokens, lengths, y, dropout_rate=0.0)
        a, b = (model(tokens, lengths, y, dropout_rate=0.3,
                      generator=torch.Generator().manual_seed(1))
                for _ in range(2))
    torch.testing.assert_close(same, want, rtol=0, atol=1e-6)
    assert torch.equal(a, b) and not torch.allclose(a, want, atol=1e-3)


def test_build_model_filters_like_jax():
    model = build_model("model.Transformer", SRC_V, TGT_V, 1, 1,
                        model_args={**DIMS, "dropout": 0.3, "lr": 0.1,
                                    "num_heads": None},
                        compat_args={"tgt_input": "bos",
                                     "scan_layers": True, "unknown": 1},
                        precision_args={"compute_dtype": "float32"})
    assert isinstance(model, Transformer)
    assert model.tgt_input == "bos" and model.dropout == 0.3
    assert len(model.encoder_layers) == DIMS["num_layers"]
    # num_heads=None is dropped, so the default of 8 applies:
    assert model.encoder_layers[0].self_attn.num_heads == 8


@pytest.mark.parametrize("name,precision,error", [
    ("lstm", None, NotImplementedError),
    ("model.EncoderDecoderGRUAttn", None, NotImplementedError),
    ("Transformer", {"compute_dtype": "bfloat16"}, NotImplementedError),
    ("nope", None, ValueError),
])
def test_build_model_refusals(name, precision, error):
    with pytest.raises(error):
        build_model(name, SRC_V, TGT_V, 1, 1, model_args=DIMS,
                    precision_args=precision)
