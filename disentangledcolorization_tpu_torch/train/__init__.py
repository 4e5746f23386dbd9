"""Stage-2 (colorizer) training: losses, optimizers, train state, steps, device data."""
