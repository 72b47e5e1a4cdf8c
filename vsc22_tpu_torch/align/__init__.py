"""Temporal alignment: copied-segment localization over frame-similarity maps."""
