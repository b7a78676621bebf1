"""H.264 baseline encoder: host entropy pack + torch device compute."""
