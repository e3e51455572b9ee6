"""Plain fp32 PyTorch (TF32 off) that decides a cell's `correct`.

Written from the published Wan 2.1 / Seaweed-APT equations, with frozen
copies of the arithmetic the program's own inputs need (the UniPC step).
It imports neither JAX, nor the JAX package, nor anything of the port,
and reads the weights the benchmark made from the seed: never what the
program derived from them.
"""
