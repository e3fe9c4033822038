"""The plain reference that decides a run's `correct`.

A frozen copy, in plain PyTorch, of the plain paths of `vdetr_tpu_torch`
at commit 9762b5a (the functions its CPU tensors take): voxelize, the
keyed sparse convs as a neighbour map by `searchsorted` and a gather and
matmul per offset, the SparseResNet and FPN, FPS, the decoder with the
vertex-RPE attention materialized, the criterion with the auction
matcher, AdamW, and the eval step's empty-box counts and NMS loop. Only
the keyed route, float32 and one process are kept. Parameter names are
the program's, so that a state dict of either loads into the other.

It imports nothing of the program, of JAX or of the JAX package, and
takes nothing the program made: the harness hands it the same scenes and
the same seeded weights it hands the program, and it works out the voxel
grids, the maps, the FPS picks and the matcher's assignments again.
"""
