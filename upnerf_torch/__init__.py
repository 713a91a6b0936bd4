"""upnerf_torch: the PyTorch/CUDA port of up-nerf-tpu for NVIDIA Hopper.

The JAX package `upnerf` is the reference; each module here names the JAX
module it mirrors and is held against it by `tests/test_torch_*.py`. This
package imports `torch` and never `jax` or `upnerf`.

Subpackages (same layout as `upnerf`):
  geometry  SE(3) exp / log maps, pose algebra, novel-view orbit, rays,
            Procrustes alignment and pose errors
  ops       dense layer precision policy, bilinear feature gathers, the fused
            render kernels, forward and backward (train and frozen-model
            modes; CUDA C++ in csrc/), with their plain PyTorch versions and
            the autograd.Function that joins them, the trunk kernel of the
            fast render's probe, the trunk + heads kernels (forward and
            backward) and the static render from PE rows of the
            `fused_train`-off path, the flash-attention kernel of the
            extractors, kernel build
  models    NeRF field (nn.Module, reference state_dict names), transient
            net, embeddings
  render    stratified + inverse-CDF sampling, volume compositing,
            coarse+fine render_rays in all three schedule phases, routed by
            the tpu.fused_* flags as in the JAX package, fast serving renders
            (interval tightening)
  train     the train step (state, schedules, losses, Adam, make_train_step),
            the val renderer, the warp detector, the Trainer loop
  data      scene metadata (Phototourism, custom), COLMAP models, scene
            images (LANCZOS downscale without PIL), the compact ray store
            (build_arrays), its .npy cache
  config    the flat dotted-key config, YAML read and written without PyYAML
  evaluate  chunked novel-view renders, test-time optimization, PSNR / SSIM /
            LPIPS
  features  the offline extractors: ViT backbone, DINO descriptor maps, DPT
            inverse depth, weight converters, image reading without PIL
  utils     reference-checkpoint weight bridge, both ways; the extractors'
            npz-layout bridge; checkpoints, metric logging, visualisation
  cli       train, prepare_cache, render_video, preprocess, tto, eval
"""

import torch

__version__ = "0.1.0"

# f32 products on the card stay f32: the JAX reference runs its f32 mode at
# Precision.HIGHEST, and TF32 keeps only ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
