"""Command-line entry points of the port: ``python -m
fhpe_tpu_torch.cli.train``, ``cli.fpd_train`` and ``cli.test``, and their
shared wiring (``cli.common``)."""
