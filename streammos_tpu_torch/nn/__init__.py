from streammos_tpu_torch.nn.blocks import (BN, BasicBlock, BasicConv2d,
                                           CatFusion, ChannelAtt, DownSample2D,
                                           PointNet, PointNetStacker,
                                           PredBranch, UnbalanceBasicBlock)
from streammos_tpu_torch.nn.deform import (DeformAttnLayer, DeformAttnModule,
                                           MSDeformAttn)
from streammos_tpu_torch.nn.encoder import ConvStage, MultiViewEncoder

__all__ = [
    "BN",
    "BasicBlock",
    "BasicConv2d",
    "CatFusion",
    "ChannelAtt",
    "ConvStage",
    "DeformAttnLayer",
    "DeformAttnModule",
    "DownSample2D",
    "MSDeformAttn",
    "MultiViewEncoder",
    "PointNet",
    "PointNetStacker",
    "PredBranch",
    "UnbalanceBasicBlock",
]
