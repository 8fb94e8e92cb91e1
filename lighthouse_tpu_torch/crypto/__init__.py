"""BLS12-381 for the port: host oracles (pure Python) and the device
batch verify (``tpu_backend``), whose kernels live in ``csrc/bls381.cu``."""
