"""ABR ladder helpers the settings layer needs (rung specs)."""
