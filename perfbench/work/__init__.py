"""Frozen operation and byte counts of the port's hand-written kernels, one
kernel a file, at a cell's shapes: each input read once, each output
written once, the operations the function needs (for attention, the live
causal pairs). They are copies of the port's ``work`` functions as they
stood when the benchmark was written, so that a later kernel of another
design is held to the same work; ``perfbench/tests`` holds them equal to
the port's at today's shapes.

The bound of a launch is max(operations / peak, bytes / bandwidth), in
seconds, with the peaks of ``perfbench.lib.peaks``.
"""
