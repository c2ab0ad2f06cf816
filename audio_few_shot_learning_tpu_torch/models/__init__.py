"""Encoder, attention fusion, projection and the episode model."""
