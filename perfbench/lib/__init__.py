"""The harness: cells as data, weights and token feeds from the seed, the
timed window, the trace reading and the comparison with the reference."""
