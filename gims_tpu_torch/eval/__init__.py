"""Evaluation of the port: the homography benchmark (``homography.py``),
match counting (``matches.py``), metrics, RANSAC and geometry helpers."""
