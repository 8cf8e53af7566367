"""The benchmark of the PyTorch and CUDA port (``fhpe_tpu_torch``)."""
