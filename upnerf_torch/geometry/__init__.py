from . import rays, se3
from .rays import get_rays, pixel_directions
from .se3 import compose, compose_pair, get_novel_view_poses, make_pose, se3_to_SE3

__all__ = [
    "compose",
    "compose_pair",
    "get_novel_view_poses",
    "get_rays",
    "make_pose",
    "pixel_directions",
    "rays",
    "se3",
    "se3_to_SE3",
]
