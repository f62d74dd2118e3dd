"""The roofline of the port on one card: the card's figures (``hw``), an
op-and-kernel counter run under ``FakeTensorMode`` (``count``, in place of
the reference's HLO parser) and the analysis of the dry run's records
(``analysis``)."""
