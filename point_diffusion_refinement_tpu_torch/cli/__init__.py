"""Command-line entry points (train / generate / preprocess / eval bookkeeping)."""
