"""The flagship network and its blocks, NHWC."""
