"""Field-wise maps over the port's state containers (NamedTuples, dicts,
dataclasses of tensors), and the port's form of `lax.cond`."""
from __future__ import annotations

import dataclasses

import torch

from lins_tpu_torch.utils.metrics import trace_scope


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
    `name` whose `kept` is `pred`.

    On the card both sides are computed and selected on the device, so no
    flag is read back to the host, and the span of a false `pred` is work
    computed and discarded; on the CPU, where the read is free, `branch`
    runs only when it is taken.
    """
    with trace_scope(name, kept=pred):
        return _decide(pred, branch, keep)


def _decide(pred: torch.Tensor, branch, keep):
    if pred.device.type == "cpu":
        return branch() if bool(pred) else keep
    return select_cond(pred, branch, keep)


def select_cond(pred: torch.Tensor, branch, keep):
    """`cond` as the card runs it, on any device: both sides computed,
    selected leaf by leaf."""
    return tree_where(pred, branch(), keep)
