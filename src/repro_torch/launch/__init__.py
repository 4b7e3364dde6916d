"""Launch substrate on PyTorch (the JAX package's `launch`): the mesh
descriptions (`mesh`), the abstract inputs and step functions of every
(architecture × shape) cell (`specs`) and the training launcher
(`train`).  The reference's XLA dry-run (`dryrun`, `extrapolate`) has no
counterpart here: it compiles partitioned programs for a TPU mesh without
its devices, which PyTorch cannot do (ROADMAP.md, "Done").

seed_fixtures: quarantined seed substrate, as in the JAX package — the
training-launch stack is held against the reference by
`tests/test_torch_train.py` and `tests/test_torch_sharding.py` and run on
the card by `chip_smoke.py`'s `train_lm` phase, never imported by the
port's product packages.

Marker-only package ``__init__``: importing it must stay side-effect
free (no submodule imports).
"""
