"""Evaluation helpers: batched reconstruction, detection, kernel quality."""
