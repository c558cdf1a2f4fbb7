"""The host side of the port, in numpy: the SemanticKITTI taxonomy, the
datasets, augmentation, copy-paste, the drop list and the worker pool.
Nothing here imports torch: the pool's workers import these modules."""
