"""Channels-last ops of the port: convolution, GroupNorm, resampling."""
