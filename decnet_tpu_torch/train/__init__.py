"""Training of the faithful DecNet: losses, metrics, optimizer, steps, checkpoints."""
