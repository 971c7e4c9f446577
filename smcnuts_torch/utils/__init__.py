"""Utilities."""
