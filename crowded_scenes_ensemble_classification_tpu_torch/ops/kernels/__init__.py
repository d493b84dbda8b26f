"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel is a `torch.library.custom_op` in the `csec` namespace: its CPU
implementation is the plain version, its CUDA implementation checks the
arguments and launches the kernel, and its fake implementation gives
`torch.export` the output's shape, so an exported program calls the kernel."""
