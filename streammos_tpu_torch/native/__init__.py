"""The native loader core: C++ scan IO, transform, crop, resampling and
eval-frame assembly behind ctypes, built with g++ into `build/native/`."""
from streammos_tpu_torch.native.api import (assemble_eval_frame,
                                            filter_points, load_labels,
                                            load_scan, resample_indices,
                                            transform)

__all__ = [
    "assemble_eval_frame",
    "filter_points",
    "load_labels",
    "load_scan",
    "resample_indices",
    "transform",
]
