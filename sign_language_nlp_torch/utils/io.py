"""Filesystem / serialization helpers: the port's copy of the parts of
sign_language_nlp_tpu/utils/io.py that it uses. The YAML helpers
(`save_args`) are left out: the card's machine has no `yaml`."""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any


def normpath(path: str | os.PathLike) -> str:
    return os.path.normpath(str(path))


def exists(path: str | os.PathLike) -> bool:
    return os.path.exists(str(path))


def create_if_missing(directory: str | os.PathLike) -> None:
    os.makedirs(str(directory), exist_ok=True)


def filename(path: str | os.PathLike, with_ext: bool = True) -> str:
    p = Path(path)
    return p.name if with_ext else p.stem


def filter_files(directory: str | os.PathLike, ext: str = "json",
                 path_as_str: bool = False) -> list:
    """All files under `directory` with extension `ext`, sorted by name."""
    paths = sorted(Path(directory).glob(f"*.{ext}"))
    return [str(p) for p in paths] if path_as_str else paths


def get_hash(obj: Any) -> str:
    """Deterministic content hash of a JSON-serializable object.

    Used to key the dataset's transient working-file cache
    (reference dataset_builder.py:29-37 semantics).
    """
    payload = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def read_json(path: str | os.PathLike) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def save_json(obj: Any, path: str | os.PathLike) -> None:
    create_if_missing(Path(path).parent)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=_json_default)


def _json_default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)
