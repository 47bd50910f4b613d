"""Matching and targets of the train step, keypoint utilities, and the
keypoint evaluators (``eval/``)."""
