"""Encoders and the MSF-WSI backbone."""
