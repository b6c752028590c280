"""Dataset loaders — importing this package registers all of them
(mirrors the side-effect imports in reference ``train.py:14-28``)."""

from . import (caltech101, dtd, eurosat, fgvc_aircraft, food101, imagenet,
               imagenet_variants, oxford_flowers, oxford_pets,
               stanford_cars, sun397, synthetic, ucf101)  # noqa: F401
