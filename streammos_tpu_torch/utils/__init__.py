"""Logging, the scalar stream, the confusion-matrix IoU evaluator, 3-D box
helpers and the offline visualization."""
