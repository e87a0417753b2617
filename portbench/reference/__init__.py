"""The plain reference the benchmark holds the port's outputs against:
plain PyTorch and NumPy, written from the algorithms' statements. It
imports neither jax, nor salamander_tpu, nor anything of
salamander_tpu_torch, and takes nothing the program made: it draws the
same seeded starting points and resamples itself, from the inputs the
benchmark hands both sides."""
