"""OmniHuman: the conditioned DiT, audio features and pose heatmaps."""
