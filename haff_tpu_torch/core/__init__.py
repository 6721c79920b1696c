"""Configuration and dtype policy (no device or mesh state here)."""
