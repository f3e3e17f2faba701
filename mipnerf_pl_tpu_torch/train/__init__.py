"""Training: learning-rate schedule and optimizer."""
