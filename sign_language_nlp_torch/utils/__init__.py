"""Logging and filesystem helpers: the port's own copy of what it uses
from sign_language_nlp_tpu/utils (no YAML, no JAX tooling)."""
from .io import (create_if_missing, exists, filename, filter_files, get_hash,
                 normpath, read_json, save_json)
from .logging import auto_log_progress, log, set_verbosity, warn

__all__ = ["auto_log_progress", "create_if_missing", "exists", "filename",
           "filter_files", "get_hash", "log", "normpath", "read_json",
           "save_json", "set_verbosity", "warn"]
