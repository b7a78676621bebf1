"""Farm helpers the settings layer needs (tenant labels and shares)."""
