"""The plain reference of the learned Helmholtz solvers, in plain PyTorch.

It imports neither JAX nor anything of the program under test. From the
inputs the benchmark hands it (sound-speed maps, source maps, the raw
npz of trained weights) it works out everything again: the PML profiles,
the dense spectral axis operators, k^2, the sigma channels, the weights'
layouts and the recurrent UNet with its hidden states.

`precision` names the rounding of the operands of each product group
(`rounding.round_to`): the DoubleConvs, the head, the strided and
transposed convs, and the operator.
"""
