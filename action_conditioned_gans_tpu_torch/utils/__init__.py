"""Checkpoints and metric writing for the training loop (port of ``utils/``)."""
