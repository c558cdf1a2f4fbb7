from streammos_tpu_torch.models.stream_mos import (RefineBranch, StreamMOSNet,
                                                   featurize, memory_shape,
                                                   tta_expand_folded,
                                                   tta_scores)

__all__ = [
    "RefineBranch",
    "StreamMOSNet",
    "featurize",
    "memory_shape",
    "tta_expand_folded",
    "tta_scores",
]
