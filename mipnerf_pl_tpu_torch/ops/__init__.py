"""Ray math, sampling and compositing on tensors (plain torch)."""
