from .transforms import (DEFAULT_BUCKETS, FormatBatch, LoadClip, Normalize,
                         PadToBucket, Resize)

__all__ = ["DEFAULT_BUCKETS", "FormatBatch", "LoadClip", "Normalize",
           "PadToBucket", "Resize"]
