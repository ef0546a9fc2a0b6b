"""Cross-validation splitting (kfold.py); the grid driver and scoring
come with a later slice."""
