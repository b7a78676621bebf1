"""Core video types and device resolution."""
