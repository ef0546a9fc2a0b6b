"""Convert a JAX checkpoint into a checkpoint of the PyTorch port.

Reads `<src>/params.msgpack` (written by the JAX pipeline's
`save_checkpoint`) with `flax.serialization.msgpack_restore`, maps the
flax tree onto the port Transformer's state dict with
`sign_language_nlp_torch.models.convert.params_from_jax`, and writes
`<dst>/params.pt` with the same `params.json` descriptor. It lives
outside the port's package so that the package stays free of jax/flax.

    python scripts/jax_checkpoint_to_torch.py --src <jax-workdir> \
        --dst <torch-workdir>
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sign_language_nlp_torch.models.convert import params_from_jax  # noqa: E402
from sign_language_nlp_torch.training.checkpoint import (  # noqa: E402
    load_descriptor, save_checkpoint)


def convert(src: str, dst: str) -> str:
    """Returns the path of the written `<dst>/params.pt`."""
    import flax.serialization

    with open(os.path.join(src, "params.msgpack"), "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    return save_checkpoint(dst, params_from_jax(tree), load_descriptor(src))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="JAX workdir with params.msgpack/params.json")
    ap.add_argument("--dst", required=True, help="output workdir")
    args = ap.parse_args(argv)
    print(convert(args.src, args.dst))


if __name__ == "__main__":
    main()
