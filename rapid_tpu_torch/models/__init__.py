"""Engine state and the virtual-cluster driver."""
