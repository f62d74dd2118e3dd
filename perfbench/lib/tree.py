"""Paths and leaves of a parameter tree of dicts and lists (the port's
layout), read without importing the port."""
from __future__ import annotations


def leaves(tree, path=()):
    """[(path, leaf)] of a tree of dicts and lists, in the tree's order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, path + (str(i),))]
    return [(path, tree)]


def rebuild(tree, values: dict, path=()):
    """``tree``'s structure with each leaf replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(v, values, path + (str(i),))
                          for i, v in enumerate(tree))
    return values[path]
