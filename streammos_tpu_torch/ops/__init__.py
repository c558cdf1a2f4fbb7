from streammos_tpu_torch.ops.deform_attn import (deform_attn_sample,
                                                 deform_attn_sample_ref)
from streammos_tpu_torch.ops.fused_header import (fused_header_reference,
                                                  fused_header_tta)
from streammos_tpu_torch.ops.resize import resize_bilinear_align_corners
from streammos_tpu_torch.ops.sample import grid_to_point, grid_to_point_ref
from streammos_tpu_torch.ops.tta_fold import (grid_to_point_tta, orient_grid,
                                              voxel_max_pool_tta)
from streammos_tpu_torch.ops.voxel_pool import (voxel_max_pool,
                                                voxel_max_pool_ref)

__all__ = [
    "deform_attn_sample",
    "deform_attn_sample_ref",
    "fused_header_reference",
    "fused_header_tta",
    "grid_to_point",
    "grid_to_point_ref",
    "grid_to_point_tta",
    "orient_grid",
    "resize_bilinear_align_corners",
    "voxel_max_pool",
    "voxel_max_pool_ref",
    "voxel_max_pool_tta",
]
