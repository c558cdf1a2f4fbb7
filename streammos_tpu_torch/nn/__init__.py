from streammos_tpu_torch.nn.blocks import (BN, BasicBlock, BasicBlockV2,
                                           BasicConv2d, BranchAttFusion,
                                           CatFusion, ChannelAtt, CSAtt,
                                           DownSample2D, PointAttFusion,
                                           PointNet, PointNetStacker,
                                           PredBranch, SpatialAtt,
                                           UnbalanceBasicBlock, make_fusion)
from streammos_tpu_torch.nn.deform import (DeformAttnLayer, DeformAttnModule,
                                           MSDeformAttn)
from streammos_tpu_torch.nn.encoder import ConvStage, MultiViewEncoder

__all__ = [
    "BN",
    "BasicBlock",
    "BasicBlockV2",
    "BasicConv2d",
    "BranchAttFusion",
    "CSAtt",
    "CatFusion",
    "ChannelAtt",
    "ConvStage",
    "DeformAttnLayer",
    "DeformAttnModule",
    "DownSample2D",
    "MSDeformAttn",
    "MultiViewEncoder",
    "PointAttFusion",
    "PointNet",
    "PointNetStacker",
    "PredBranch",
    "SpatialAtt",
    "UnbalanceBasicBlock",
    "make_fusion",
]
