"""Matching track: similarity-matrix candidates, classify filter, SAM decode."""
