"""Evaluation: batched reconstruction and (defended) accuracy, classifier
training and its cache, detection by reconstruction error, kernel
quality gates."""
