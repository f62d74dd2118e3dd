"""The plain reference: fp32 PyTorch with TF32 off, written from the
models' published equations and the configurations' files. It imports
nothing of the port (``repro_torch``), of the JAX package or of JAX, and
takes only what the benchmark made: the seeded parameter values, read by
the names of the port's parameter tree, and the token ids."""
