"""Matching and targets of the train step."""
