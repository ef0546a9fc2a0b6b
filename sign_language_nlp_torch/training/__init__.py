"""Checkpoint persistence (the training loop comes with a later slice)."""
