"""The benchmark's plain reference: frozen plain PyTorch/NumPy copies of
the CMGAN generator, the metric discriminator, the featurization, the
SCP-GAN losses, steps and update, the data pipeline's crops, the PESQ
engine (its C++ source, built here), and the arithmetic of model FLOPs and
of K1's operations and bytes.

Nothing here imports the system under test, the JAX package or JAX: the
correctness check and the yardstick must not move when the program does.
"""
