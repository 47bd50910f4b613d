from .deformable import (MultiFrameDeformableAttention,
                         MultiFramePoseDeformableAttention,
                         MultiScaleDeformableAttention)

__all__ = ["MultiScaleDeformableAttention", "MultiFrameDeformableAttention",
           "MultiFramePoseDeformableAttention"]
