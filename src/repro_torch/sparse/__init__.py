"""Pruning masks -> tile masks -> kernel dispatch plans."""
