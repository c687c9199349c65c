"""Tensor ops of the port: augmentation, jigsaw geometry, losses."""
