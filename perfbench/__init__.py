"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell once (``perfbench/run.py``).  Nothing here imports JAX or the
JAX package, and the plain reference (``perfbench/reference``) imports
nothing of the program."""
