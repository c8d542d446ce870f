"""CPU tests of the benchmark (cases that need the card are marked ``cuda``)."""
