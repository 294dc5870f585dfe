"""Confidence polytopes (arXiv:2109.04734): the margin <-> confidence-level
conversion and the Monte-Carlo coverage harness."""
