from . import procrustes, rays, se3
from .rays import get_rays, pixel_directions
from .se3 import SE3_to_se3, SO3_to_so3, compose, compose_pair, get_novel_view_poses, invert, make_pose, se3_to_SE3

__all__ = [
    "SE3_to_se3",
    "SO3_to_so3",
    "compose",
    "compose_pair",
    "get_novel_view_poses",
    "get_rays",
    "invert",
    "make_pose",
    "pixel_directions",
    "procrustes",
    "rays",
    "se3",
    "se3_to_SE3",
]
