"""Planar geometry and affine crops."""
