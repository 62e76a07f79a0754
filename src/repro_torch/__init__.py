"""PyTorch/CUDA port of the Ouroboros serving stack.

A second package beside the JAX reference (``src/repro``): the same
subpackages and names, PyTorch tensors inside, and hand-written CUDA
kernels (``csrc/``) where the reference runs a Pallas kernel.  Which
path runs follows the tensors' device: CUDA tensors launch the kernels,
CPU tensors take each kernel's plain PyTorch version.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise (:func:`repro_torch.device.resolve_device`) instead of
falling back to the CPU.
"""
