"""upnerf_torch: the PyTorch/CUDA port of up-nerf-tpu for NVIDIA Hopper.

The JAX package `upnerf` is the reference; each module here names the JAX
module it mirrors and is held against it by `tests/test_torch_*.py`. This
package imports `torch` and never `jax` or `upnerf`.

Subpackages (same layout as `upnerf`):
  geometry  SE(3) exp map, pose algebra, novel-view orbit, rays
  ops       dense layer precision policy, bilinear feature gathers, the fused
            render kernels, forward and backward (CUDA C++ in csrc/), with
            their plain PyTorch versions and the autograd.Function that
            joins them, the flash-attention kernel of the extractors, kernel
            build
  models    NeRF field (nn.Module, reference state_dict names), transient
            net, embeddings
  render    stratified + inverse-CDF sampling, volume compositing,
            coarse+fine render_rays in all three schedule phases
  train     the train step: state, schedules, losses, Adam, make_train_step
  evaluate  chunked novel-view renders
  features  the offline extractors: ViT backbone, DINO descriptor maps, DPT
            inverse depth, weight converters, image reading without PIL
  utils     reference-checkpoint weight bridge, both ways; the extractors'
            npz-layout bridge
  cli       render_video, preprocess
"""

import torch

__version__ = "0.1.0"

# f32 products on the card stay f32: the JAX reference runs its f32 mode at
# Precision.HIGHEST, and TF32 keeps only ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
