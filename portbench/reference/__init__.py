"""The plain reference of an SQMD federation round: PyTorch in fp32 with
TF32 off, written from the paper's equations. It imports nothing of the
port and takes nothing the port made: the benchmark hands it the same
data, weights, batch draws and availability it hands the port.

``precision="tf32"`` computes every matrix product and convolution with
its operands rounded to TF32 (and, on the card, TF32 allowed): the
control that a sound output check must fail.
"""
