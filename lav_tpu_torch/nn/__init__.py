"""Layers and backbones as nn.Modules whose parameter names follow the
lav_tpu params pytree keys."""
