"""The port's four examples, each runnable as
``PYTHONPATH=src python -m repro_torch.examples.<name>``:

* ``quickstart``: build a model, take its loss, one optimizer step and a
  few greedy tokens;
* ``serve_batched``: continuous batching over the dense or ring backend;
* ``systolic_topologies``: the queue topologies, the link modes on the
  ring ops with their op counts, the hybrid conv2d and the pipelined FFT;
* ``train_lm``: the training launcher on a ~10M (or, ``--full``, ~100M)
  parameter LM, with checkpoints and resume.

Each has ``main(argv=None)`` with the JAX package's example flags plus
``--device`` (default ``cuda``, which raises without a GPU) and a
``run(...)`` that does the work and returns what ``main`` prints.
"""
