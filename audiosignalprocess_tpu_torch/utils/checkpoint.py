"""Checkpoint and resume of the streaming carry.

The carry (filter histories, OLA tails, spectral FIFOs, positions) is
saved as a flat ``.npz``: ``leaf_i`` in the order ``jax.tree_util``
flattens the same structure (dict keys sorted, lists and tuples in order,
None holding no leaf) plus ``block_index``.  The format is the JAX
package's ``utils/checkpoint``, so a carry saved by its plain streaming
path loads here and the other way round.  Restarting a stream from block
k with the restored carry reproduces the uninterrupted stream.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(carry) -> list:
    if isinstance(carry, dict):
        return [leaf for k in sorted(carry) for leaf in _leaves(carry[k])]
    if isinstance(carry, (list, tuple)):
        return [leaf for v in carry for leaf in _leaves(v)]
    return [] if carry is None else [carry]


def _rebuild(template, leaves):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    if template is None:
        return None
    data = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(data, dtype=template.dtype).to(template.device)
    return type(template)(data)


def _npz(path: str) -> str:
    # np.savez appends ".npz" to a path without it, np.load does not
    return path if path.endswith(".npz") else path + ".npz"


def save_carry(path: str, carry, block_index: int) -> None:
    arrs = {f"leaf_{i}": (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v))
            for i, v in enumerate(_leaves(carry))}
    arrs["block_index"] = np.asarray(block_index, dtype=np.int64)
    np.savez(_npz(path), **arrs)


def load_carry(path: str, carry_template) -> tuple:
    """Returns (carry, block_index); the carry has the template's structure,
    and each leaf its template's dtype and device (Python ints stay ints)."""
    data = np.load(_npz(path))
    n = len(_leaves(carry_template))
    carry = _rebuild(carry_template, iter(data[f"leaf_{i}"] for i in range(n)))
    return carry, int(data["block_index"])
