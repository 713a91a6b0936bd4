from .embeddings import init_embedding
from .nerf import NeRFConfig, NeRFField, pe_weight, positional_encoding

__all__ = ["NeRFConfig", "NeRFField", "init_embedding", "pe_weight", "positional_encoding"]
