"""Offline refinement of saved predictions by the long-term memory:
voxel voting and instance voting (numpy and scipy; torch only inside
`voxel_vote_device`)."""
from streammos_tpu_torch.postprocess.voting import (instance_vote, voxel_vote,
                                                    voxel_vote_device)

__all__ = ["voxel_vote", "voxel_vote_device", "instance_vote"]
