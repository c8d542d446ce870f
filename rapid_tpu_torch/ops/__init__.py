"""Engine operations: hashing, rings, consensus, cut detection, kernels."""
