"""Helpers shared by the tests/test_torch_*.py parity tests: numpy-seeded
inputs, and the bridges between the JAX package's trees and numpy trees
(`repro_torch.convert` takes the numpy form to the port)."""
import jax.numpy as jnp
import numpy as np

from repro.core.packed import PackedWeight
from repro.core.shift_bn import BNParams, BNState
from repro_torch.convert import from_numpy_tree
from repro_torch.convert import words_to_numpy as words  # noqa: F401


def quantized(rng, shape):
    """Values k/128 in [-1, 1] (8-bit pixels): sums of up to 2^17 of them
    against +-1 weights are exact in float32 in any order, so a float
    input layer gives the same bits in JAX and in torch."""
    return (np.round(rng.uniform(-1, 1, shape) * 128) / 128).astype(np.float32)


def uniform(rng, shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def random_bn(rng, n):
    """BN params and running stats with negative and zero gammas (the flip
    and constant-bit folds) and spread means and variances."""
    gamma = rng.normal(size=n).astype(np.float32)
    gamma[0] = 0.0
    params = {"gamma": gamma, "beta": rng.normal(size=n).astype(np.float32)}
    state = {"mean": (rng.normal(size=n) * 3).astype(np.float32),
             "var": rng.uniform(0.1, 4.0, n).astype(np.float32),
             "count": np.zeros((), np.int32)}
    return params, state


def np_mlp(rng, in_dim, hidden, n_hidden=3, n_classes=10):
    dims = [in_dim] + [hidden] * n_hidden + [n_classes]
    return {"layers": [{"w": uniform(rng, (a, b)), "b": uniform(rng, (b,))}
                       for a, b in zip(dims[:-1], dims[1:])]}


def np_cnn(rng, widths, fc, img, in_ch=3, n_classes=10):
    convs, conv_bns = [], []
    ch = in_ch
    for w in widths:
        bnp, bns = random_bn(rng, w)
        convs.append({"w": uniform(rng, (3, 3, ch, w)), "bn": bnp})
        conv_bns.append(bns)
        ch = w
    flat = (img // 8) ** 2 * widths[-1]
    p1, s1 = random_bn(rng, fc)
    p2, s2 = random_bn(rng, fc)
    params = {"convs": convs,
              "fc1": {"w": uniform(rng, (flat, fc)), "bn": p1},
              "fc2": {"w": uniform(rng, (fc, fc)), "bn": p2},
              "out": {"w": uniform(rng, (fc, n_classes)),
                      "b": uniform(rng, (n_classes,))}}
    return params, {"convs": conv_bns, "fc1": s1, "fc2": s2}


def np_to_jax(tree):
    """numpy tree -> JAX package tree (BN dicts become its NamedTuples)."""
    if isinstance(tree, dict):
        if set(tree) == {"gamma", "beta"}:
            return BNParams(jnp.asarray(tree["gamma"]), jnp.asarray(tree["beta"]))
        if set(tree) == {"mean", "var", "count"}:
            return BNState(jnp.asarray(tree["mean"]), jnp.asarray(tree["var"]),
                           jnp.asarray(tree["count"]))
        return {k: np_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_to_jax(v) for v in tree)
    return jnp.asarray(tree)


def jax_to_np(tree):
    """JAX package tree -> numpy tree in the form repro_torch.convert reads."""
    opt = (lambda v: None if v is None else np.asarray(v))
    if isinstance(tree, PackedWeight):
        return {"packed": np.asarray(tree.packed), "k": tree.k,
                "kind": tree.kind, "conv_shape": tree.conv_shape,
                "orig_dtype": tree.orig_dtype, "thresh": opt(tree.thresh),
                "flip": opt(tree.flip), "fold": tree.fold}
    if isinstance(tree, BNParams):
        return {"gamma": np.asarray(tree.gamma), "beta": np.asarray(tree.beta)}
    if isinstance(tree, BNState):
        return {"mean": np.asarray(tree.mean), "var": np.asarray(tree.var),
                "count": np.asarray(tree.count)}
    if isinstance(tree, dict):
        return {k: jax_to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_to_np(v) for v in tree)
    return np.asarray(tree)


def to_port(np_tree):
    """numpy tree -> the port's tree, on the CPU."""
    return from_numpy_tree(np_tree, device="cpu")
