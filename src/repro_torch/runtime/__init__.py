"""Serving steps."""
