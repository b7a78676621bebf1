"""Codec implementations."""
