"""lighthouse_tpu_torch — the PyTorch/CUDA port of lighthouse_tpu.

The port is built slice by slice beside the JAX package, which stays the
reference it is held against.  This slice covers the BeaconState state
root: SSZ types, the SoA validator registry, the incremental and
device-resident hash caches, and the two SHA-256 Merkle kernels
(``csrc/sha256_merkle.cu``).  Entry points run on ``cuda`` unless the
caller picks the CPU with :func:`lighthouse_tpu_torch.device.
set_default_device`.
"""
