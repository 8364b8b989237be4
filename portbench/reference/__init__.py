"""Plain PyTorch references that decide ``correct``.

They import torch alone: nothing of the program under test and nothing of
the JAX package.  Matrices are packed as the program packs them (int32
words, column c at bit c % 32 of word c // 32, padding bits zero), because
that is the layout of the inputs the benchmark makes and of the outputs it
judges; every factor, inverse and product the program derives is worked out
here again from the inputs.

- ``gf2``: packing, unpacking, and the GF(2) product through float matrix
  products in blocks (exact while a block's sums stay exact in the type);
- ``ple``: M4RI's PLE decomposition (canonical pivots, L compressed) by a
  plain blocked sweep;
- ``rref``: reduced row echelon forms of a stack, and ``A X = B`` solved
  with free variables zero.
"""
