"""The offline extractors (upnerf/features/): the ViT backbone, DINO
descriptor maps, DPT inverse depth, the weight converters, and image reading
(PNG, and JPEG through the port's own codec, `jpeg.py`) and resizing without
PIL."""
