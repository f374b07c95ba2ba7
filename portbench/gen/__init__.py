"""Inputs made from the seed: point stores, CTs, weights."""
