"""Serving runtime: the decode step builder and its inputs."""
