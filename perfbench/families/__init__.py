"""Model FLOP formulas, one module a model family, found by the ``family``
a configuration names (``families/<family>.py``). Each has
``body_weights(config)``: the weights a token passes through below the
head, each counted at every call of it (``perfbench.lib.flops``)."""
