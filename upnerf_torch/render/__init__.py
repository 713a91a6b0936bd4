from .fast import FastRenderConfig, tighten_from_weights, tighten_rays
from .render_rays import RenderConfig, render_rays
from .sampling import sample_pdf, stratified_z_vals
from .volume import composite_weights

__all__ = ["FastRenderConfig", "RenderConfig", "composite_weights", "render_rays", "sample_pdf", "stratified_z_vals",
           "tighten_from_weights", "tighten_rays"]
