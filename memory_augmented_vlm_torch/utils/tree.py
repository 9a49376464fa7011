"""Walking the port's parameter trees: nested dicts and lists with tensor
(or other) leaves.

A leaf's path is the tuple of dict keys and list indices that reaches it;
`path_str` joins it with dots, as the JAX package's `utils/tree.path_str`
joins a pytree key path ("language_model.layers.3.q_proj.kernel").
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

Path = Tuple[Any, ...]


def path_str(path: Path) -> str:
    return ".".join(str(p) for p in path)


def leaves_with_path(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs, depth first, dict keys in insertion order."""
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from leaves_with_path(sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from leaves_with_path(sub, path + (i,))
    else:
        yield path, tree


def map_with_path(fn: Callable, tree, *rest, path: Path = ()):
    """A tree of `fn(path, leaf, *leaves of rest at that path)`, with
    `tree`'s structure (dicts and lists; tuples become lists)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)
