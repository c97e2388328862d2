"""The plain reference: a straightforward replay of a trace's patches.

Imports neither ``jax`` nor the JAX package nor anything of the program.
"""
