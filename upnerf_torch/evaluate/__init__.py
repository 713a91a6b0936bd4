from . import render, tto
from .lpips import LPIPS, load_lpips
from .metrics import mse, psnr, ssim
from .render import make_pose_renderer, render_image

__all__ = ["LPIPS", "load_lpips", "make_pose_renderer", "mse", "psnr", "render", "render_image", "ssim", "tto"]
