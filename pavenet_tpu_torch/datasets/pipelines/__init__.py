from .transforms import (DEFAULT_BUCKETS, Compose, FormatBatch,
                         KeypointRandomAffine, LoadClip, Normalize,
                         PadToBucket, PhotoMetricDistortion, RandomCrop,
                         RandomFlip, Resize, build_test_pipeline,
                         build_train_pipeline)

__all__ = ["DEFAULT_BUCKETS", "Compose", "FormatBatch",
           "KeypointRandomAffine", "LoadClip", "Normalize", "PadToBucket",
           "PhotoMetricDistortion", "RandomCrop", "RandomFlip", "Resize",
           "build_test_pipeline", "build_train_pipeline"]
