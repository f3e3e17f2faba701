"""Host code in C++: the training sampler's batch gather (gather.py)."""
