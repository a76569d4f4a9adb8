"""Experiment scripts: train, eval, fine_tune, experiment, export."""
