"""The port's hand-written Hopper kernels (CUDA C++ in ``csrc/``) and
their plain PyTorch versions; the public ops are in
:mod:`repro_torch.kernels.ops`."""
