"""Field-wise maps over the port's state containers (NamedTuples, dicts,
dataclasses of tensors), and the port's form of `lax.cond`."""
from __future__ import annotations

import dataclasses

import torch

from lins_tpu_torch.utils.metrics import host_read, trace_scope


def tree_map(fn, tree, *rest):
    """`fn` applied leaf by leaf to one or more containers of the same
    structure.  Leaves that are not tensors (a dataclass's static sizes,
    None) are taken from `tree` unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return tree


def tree_where(cond, a, b):
    """Leaf-wise torch.where(cond, a, b) over two containers.  `cond` goes
    to each leaf's device: a keyframe store sharded over several cards
    holds leaves on each."""
    return tree_map(lambda x, y: torch.where(cond.to(x.device), x, y), a, b)


def cond(pred: torch.Tensor, branch, keep, name: str):
    """`branch()` where the 0-dim bool `pred` holds, else `keep` (the
    reference package's `lax.cond(pred, branch, identity)`), inside a span
    `name`.

    The host reads `pred` (one copy, which waits for the work that set it)
    on every device and issues only the branch it names: the span records
    `kept` as that host bool, `reads` 1 and the read's wait in `read_ns`.
    A branch not taken is never issued, so nothing is computed and thrown
    away.  Every process of a sharded run reads the same replicated
    predicate, so all enter the same branch and its collectives.
    """
    with trace_scope(name, kept=pred) as span:
        return _decide(pred, branch, keep, span)


def _decide(pred: torch.Tensor, branch, keep, span):
    with host_read(span):
        taken = bool(pred)
    span["kept"] = taken
    return branch() if taken else keep


def select_cond(pred: torch.Tensor, branch, keep, span=None):
    """`cond` computed and selected, on any device: both sides computed,
    then selected leaf by leaf on the device with no host read (the form
    the card ran before its branches were decided on the host, kept as
    the reference the equality tests hold `cond` to).  In `cond`'s place
    it leaves the span's `kept` the device flag, read only at export."""
    return tree_where(pred, branch(), keep)
