"""Placements: logical-axis rules resolved to DTensor placements."""
