"""Data pipelines of the port."""
