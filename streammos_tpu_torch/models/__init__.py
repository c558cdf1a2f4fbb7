from streammos_tpu_torch.models.stream_mos import (RefineBranch, StreamMOSNet,
                                                   bev_label_from_points,
                                                   featurize, memory_shape,
                                                   refine_loss,
                                                   single_frame_loss,
                                                   stage_forward,
                                                   streaming_loss, tta_expand,
                                                   tta_expand_folded,
                                                   tta_scores)

__all__ = [
    "RefineBranch",
    "StreamMOSNet",
    "bev_label_from_points",
    "featurize",
    "memory_shape",
    "refine_loss",
    "single_frame_loss",
    "stage_forward",
    "streaming_loss",
    "tta_expand",
    "tta_expand_folded",
    "tta_scores",
]
