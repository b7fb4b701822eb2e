"""lav_tpu_torch — the PyTorch/CUDA port of lav_tpu for NVIDIA Hopper.

It mirrors lav_tpu's layout so that each module's counterpart is easy to
find, imports neither `jax` nor `lav_tpu`, and keeps the JAX package's NHWC
layout at its public functions.  Plain tensor code is PyTorch; each Pallas
kernel of lav_tpu on the ported path is a CUDA C++ kernel under `csrc/`,
built with `nvcc` for `sm_90a` at first use and bound with `ctypes`.

Package layout:
  config.py  LAVConfig, v2_config, tiny_config (a copy)
  nn/        layers, ResNet, ERFNet, attention pooling (nn.Modules)
  core/      geometry, affine crops (kernel `crop_shared`)
  ops/       point painting, pillar featurizer (kernel `pillar_scatter_max`),
             peak decode
  models/    LiDAR model, camera nets, UniPlanner inference
  agent/     EKF, PID, control, the batched agent tick, setup helper
  utils/     device selection, kernel build/load, weight conversion
"""
