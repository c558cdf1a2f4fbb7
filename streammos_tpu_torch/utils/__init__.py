"""Logging, the scalar stream and the confusion-matrix IoU evaluator."""
