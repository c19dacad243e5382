"""Shared harness of the port's conformance tests (tests only): carry a
reference (JAX) parameter tree into the bridge's numpy form."""
import numpy as np

from repro.core.bsr import BSRMatrix


def jax_tree_to_numpy(tree):
    """Nested dicts of jax arrays / BSRMatrix -> nested dicts of numpy
    arrays, packed leaves as the bridge's dict form."""
    if isinstance(tree, BSRMatrix):
        return {"idx": np.asarray(tree.idx), "vals": np.asarray(tree.vals),
                "scale": np.asarray(tree.scale),
                "zero": np.asarray(tree.zero), "shape": tuple(tree.shape),
                "group_size": tree.group_size, "bits": tree.bits}
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
