"""The offline extractors (upnerf/features/): the ViT backbone, DINO
descriptor maps, DPT inverse depth, the weight converters, and image reading
and resizing without PIL."""
