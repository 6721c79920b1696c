"""Modules of the port (float path), NHWC at public boundaries."""
