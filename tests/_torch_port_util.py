"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded numpy inputs and parameter trees, handed to both."""

import jax
import numpy as np


def randomize_tree(tree, seed: int, scale: float = 1.0):
    """Replace every leaf of a JAX params tree by a seeded normal draw:
    kernels at fan-in scale (fan-in = every axis but the last, or the first
    axis for the attention ``qkv`` kernel), vectors at 0.2 around their
    init (so zero-init convs, norm scales and biases all carry signal)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        shape = np.shape(node)
        name = path[-1]
        if name == "kernel":
            if path[-2] == "qkv":
                fan_in = shape[0]
            elif path[-2] == "proj" and len(shape) == 3:
                fan_in = shape[0] * shape[1]
            else:
                fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) * scale / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name == "w" and path[-2] == "gamma":
            v = np.asarray(node) * (1.0 + 0.05 * rng.standard_normal())
        elif name == "b" and path[-2] == "gamma":
            v = np.asarray(node) + 0.3 * rng.standard_normal()
        else:
            v = 0.2 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    return walk(tree, ())


def seeded_tree(model, seed: int):
    """``model.init_params`` with every leaf replaced as
    :func:`randomize_tree` replaces it, without running the initialization:
    the tree's structure and shapes come from ``jax.eval_shape``, and the
    schedule's values (which ``randomize_tree`` perturbs rather than
    replaces) from its own init. Equal, leaf for leaf, to
    ``randomize_tree`` of an eager ``init_params``, which runs the whole
    network op by op on the CPU."""
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, np.float32), shapes)
    if "gamma" in tree:
        tree["gamma"] = jax.tree_util.tree_map(
            np.asarray, model.schedule.init_params())
    return randomize_tree(tree, seed)
