from .render import make_pose_renderer, render_image

__all__ = ["make_pose_renderer", "render_image"]
