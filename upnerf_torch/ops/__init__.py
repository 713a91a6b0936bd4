from .linear import dense
from .render_train import RTStatic, render_train_rays_fwd, render_train_rays_plain

__all__ = ["RTStatic", "dense", "render_train_rays_fwd", "render_train_rays_plain"]
