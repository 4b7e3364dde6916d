"""Layer loops over stacked parameters, and the tree helpers they need.

The JAX package scans (`lax.scan`) a block's layer body over parameters
stacked on a leading axis, so one compiled body serves every layer.
Eager PyTorch compiles nothing: `scan` is a Python loop over that axis
with `lax.scan`'s contract, and the parameter tree keeps the reference's
stacked layout so weights carry across leaf for leaf.

Trees are nested dicts, lists and tuples (NamedTuples too, such as the
optimizer's `AdamWState`) with tensors at the leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` (and the same leaves of `rest`),
    keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        # a NamedTuple takes its fields as arguments, not one iterable
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of `tree`, in the order `tree_map` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def scan(f: Callable, init: Any, xs: Any,
         length: Optional[int] = None) -> Tuple[Any, None]:
    """`carry, _ = f(carry, xs[i])` for each i of the leading axis; returns
    (the last carry, None).  No body of the port emits a per-step output
    (decode writes its caches in place), so none is stacked."""
    n = length if length is not None else tree_leaves(xs)[0].shape[0]
    # each stacked leaf is split once: indexing it per layer would make
    # autograd add a zero gradient the size of the whole stack for every
    # layer (O(L^2) bytes in the backward); unbind's backward stacks once
    split = [a.unbind(0) for a in tree_leaves(xs)]
    carry = init
    for i in range(n):
        layer = iter(split)
        carry, _ = f(carry, tree_map(lambda _: next(layer)[i], xs))
    return carry, None
