"""Server kernels of the port: hand-written CUDA C++ for sm_90a under
``csrc/``, each beside its plain PyTorch version (``ref``). ``ops`` is the
entry point: it dispatches by the device of the tensors it is given."""
