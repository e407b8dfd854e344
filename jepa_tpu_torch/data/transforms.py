"""Image normalization constants (counterpart of the constants in
jepa_tpu/data/transforms.py). The device transforms are not ported yet."""

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
