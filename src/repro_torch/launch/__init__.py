"""Launch substrate on PyTorch (the JAX package's `launch`): the mesh
descriptions (`mesh`), the abstract inputs and step functions of every
(architecture × shape) cell (`specs`), the training launcher (`train`,
DTensor placement over a `(data, model)` or `(pod, data, model)` mesh),
and the dry run (`dryrun`, `extrapolate`): each cell's step run once on
fake tensors over a fake process group of 256 or 512 ranks, its
per-device FLOPs, bytes, collectives and memory counted on rank 0's
local shards, and the counts fitted in the layer counts.

seed_fixtures: quarantined seed substrate, as in the JAX package — the
training-launch stack is held against the reference by
`tests/test_torch_train.py` and `tests/test_torch_sharding.py` and run on
the card by `chip_smoke.py`'s `train_lm` and `lm_mesh` phases, never
imported by the port's product packages.

Marker-only package ``__init__``: importing it must stay side-effect
free (no submodule imports).
"""
