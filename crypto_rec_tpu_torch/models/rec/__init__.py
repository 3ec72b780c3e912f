"""Collaborative-filtering engine and pipeline phases."""
