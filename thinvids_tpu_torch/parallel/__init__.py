"""GOP planning and wave dispatch on one device."""
