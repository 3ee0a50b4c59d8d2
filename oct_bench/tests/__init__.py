"""CPU tests of the benchmark harness; the cuda-marked ones run on the card."""
