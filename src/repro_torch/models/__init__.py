"""Model layers, the decoder-only LM, and its configuration."""
