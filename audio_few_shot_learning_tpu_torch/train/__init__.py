"""Evaluation/serving engine and the weight bridge."""
