"""Configuration and device handling."""
