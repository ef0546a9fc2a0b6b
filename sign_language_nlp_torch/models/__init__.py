"""Transformer model, initialisers, registry and flax→torch conversion."""
